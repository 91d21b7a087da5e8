"""The port's sharding rules on DTensor (``repro_torch.distributed.
sharding``) against the JAX package's, and sharded training on CPU worlds.

On both production meshes (as mesh-like objects: the rules read only axis
names and sizes) and under ``rules_for`` plain, ``seq_sharding`` and
``dp_over_model``, for every arch: the rules are equal; every port
parameter's spec is the reference leaf's (found through the interop
mapping) with its stacked layer axes dropped, and its local shard shape is
``NamedSharding(AbstractMesh(...), spec).shard_shape`` of the reference's,
stacked axes dropped.  ``zero_pspecs`` differs only where the reference put
the data axes on a stacked layer axis (``ZERO_LAYER_AXIS``), and each
arch's per-rank ZeRO bytes are the reference's.

Gloo worlds of 2 and 4 processes (``tests/_torch_dist.py``) run the sharded
train step against the one-process step, a decode step over
sequence-sharded caches and the elastic restore.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS
from repro.configs import get_config as ref_config
from repro.distributed import sharding as RS
from repro.models import init_encdec as ref_init_encdec
from repro.models import init_lm as ref_init_lm
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as S
from repro_torch.launch import specs as SP
from repro_torch.models.lm import applications

from _torch_dist import run_worlds
MESHES = {"pod256": {"data": 16, "model": 16},
          "pod512": {"pod": 2, "data": 16, "model": 16}}
VARIANTS = {"plain": {}, "seq": {"seq_sharding": True},
            "dp": {"dp_over_model": True}}
#: archs whose reference ZeRO specs put the data axes on the stacked layer
#: axis of every layer leaf (layers divisible by dp: 48 and 32 by 16, 32 by
#: 32); the port's per-layer leaves take another dim (ROADMAP Queue 3)
ZERO_LAYER_AXIS = {
    "pod256": {"chameleon-34b", "internlm2-20b", "phi3.5-moe-42b-a6.6b",
               "stablelm-3b"},
    "pod512": {"phi3.5-moe-42b-a6.6b", "stablelm-3b"},
}


def mesh_like(name: str) -> SimpleNamespace:
    shape = MESHES[name]
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def abstract(name: str) -> AbstractMesh:
    shape = MESHES[name]
    return AbstractMesh(tuple(shape.values()), tuple(shape))


@functools.lru_cache(maxsize=None)
def trees(arch: str):
    """(reference leaves by path, the port's fake model) at full width."""
    cfg = ref_config(arch)
    init = ref_init_encdec if cfg.is_encdec else ref_init_lm
    tree = jax.eval_shape(lambda r: init(r, cfg), jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return tree, {RS._path_str(p): leaf for p, leaf in flat}, \
        SP.params_struct(get_config(arch))


@functools.lru_cache(maxsize=None)
def ref_shard_shape(mesh: str, spec: tuple, shape: tuple) -> tuple:
    """JAX's local shard shape of ``shape`` under ``spec`` on ``mesh``."""
    return tuple(JNamedSharding(abstract(mesh), JP(*spec)).shard_shape(shape))


def ref_path(cfg, name: str) -> tuple[str, int]:
    """A port parameter's reference leaf and its number of stacked axes."""
    parts = name.split(".")
    if cfg.is_encdec and parts[0] in ("enc", "dec"):
        return "/".join([parts[0]] + parts[2:]), 1
    if parts[0] == "blocks":
        app = next(a for a in applications(cfg) if a.block == int(parts[1]))
        pre = ["groups", str(app.group)] + ([app.seg] if app.seg else [])
        return "/".join(pre + parts[2:]), len(app.index)
    return "/".join(parts), 0


def ref_specs(tree, fn) -> dict:
    specs = fn(tree)
    leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    paths = [RS._path_str(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    return dict(zip(paths, leaves))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_param_specs_and_shard_shapes(arch, mesh, variant):
    cfg = get_config(arch)
    m = mesh_like(mesh)
    rules = S.rules_for(cfg, m, **VARIANTS[variant])
    ref_rules = RS.rules_for(ref_config(arch), m, **VARIANTS[variant])
    assert rules.rules == ref_rules.rules
    tree, leaves, model = trees(arch)
    want = ref_specs(tree, lambda t: RS.params_pspecs(t, ref_rules))
    got = S.params_pspecs(model, rules)
    for name, p in model.named_parameters():
        path, k = ref_path(cfg, name)
        leaf = leaves[path]
        assert tuple(leaf.shape[k:]) == tuple(p.shape), name
        assert tuple(want[path])[k:] == tuple(got[name]), \
            (name, want[path], got[name])
        assert all(a is None for a in tuple(want[path])[:k]), name
        assert ref_shard_shape(mesh, tuple(want[path]), tuple(leaf.shape))[
            k:] == S.NamedSharding(m, got[name]).shard_shape(p.shape), name
    assert {n: s.spec for n, s in S.params_shardings(model, m, rules)
            .items()} == got


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zero_pspecs(arch, mesh):
    """Equal but where the reference put the data axes on a stacked layer
    axis; the per-rank bytes of the float32 state equal either way."""
    cfg = get_config(arch)
    m = mesh_like(mesh)
    rules = S.rules_for(cfg, m)
    ref_rules = RS.rules_for(ref_config(arch), m)
    tree, leaves, model = trees(arch)
    want = ref_specs(tree, lambda t: RS.zero_pspecs(t, ref_rules, m))
    got = S.zero_pspecs(model, rules, m)
    differ = set()
    for name, p in model.named_parameters():
        path, k = ref_path(cfg, name)
        ref = tuple(want[path])
        if ref[k:] != tuple(got[name]):
            data = ref_rules.axis("batch")
            assert data in ref[:k], (name, ref, got[name])
            differ.add(name)
    assert bool(differ) == (arch in ZERO_LAYER_AXIS[mesh]), sorted(differ)[:4]
    ref_bytes = sum(4 * math.prod(ref_shard_shape(
        mesh, tuple(want[path]), tuple(leaf.shape)))
        for path, leaf in leaves.items())
    port_bytes = sum(4 * math.prod(S.NamedSharding(m, got[n]).shard_shape(
        p.shape)) for n, p in model.named_parameters())
    assert port_bytes == ref_bytes


def test_placements_and_named_sharding():
    from torch.distributed.tensor import Replicate, Shard
    m = mesh_like("pod512")
    assert S.placements(S.P(("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert S.placements(S.P(None, "data"), m) == \
        (Replicate(), Shard(1), Replicate())
    assert S.placements(S.P(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):      # axes out of the mesh's order
        S.placements(S.P(("data", "pod")), m)
    with pytest.raises(ValueError):      # one axis on two dims
        S.placements(S.P("data", "data"), m)
    assert S.NamedSharding(m, S.P(("pod", "data"), "model")).shard_shape(
        (256, 151936)) == (8, 9496)
    assert S.P("data", None) == ("data", None)


def test_shard_passes_plain_tensors():
    x = torch.ones(2, 3)
    assert S.shard(x, "batch", None) is x            # outside use_rules
    rules = S.rules_for(get_config("qwen2-1.5b"), mesh_like("pod256"))
    with S.use_rules(rules) as r:
        assert r is rules and S.current_rules() is rules
        assert S.shard(x, "batch", None) is x        # not a DTensor
    assert S.current_rules() is None


def test_sharded_train_worlds(tmp_path):
    """A world of 2 on (2, 1) (with the int8 accounting flag) and (1, 2),
    the elastic restore onto (1, 2); a world of 4 on (2, 2): dense, MoE,
    the Mamba2 hybrid and xLSTM, every one at 2 microbatches; on (1, 2)
    and (2, 2) a reduced qwen2 with one KV head shards the queries'
    sequence (``scores_q``); on each world's last mesh a decode step with
    the caches' sequence sharded (kv_seq), at a batch of 4 and of 3 (on
    (2, 2) uneven shards).  The two worlds run at once."""
    two, four = run_worlds([("train", 2), ("train", 4)], tmp_path)
    assert two.count("OK train") == 4 and "OK elastic" in two, two
    assert four.count("OK train") == 5, four
    for arch in ("deepseek-moe-16b", "zamba2-7b", "xlstm-1.3b",
                 "{'n_kv_heads': 1}"):
        assert arch in four, four
    assert two.count("OK decode") == four.count("OK decode") == 2, \
        (two, four)
