"""GPipe over the pod axis (``repro_torch.distributed.pipeline``).

A gloo world of 4 processes on a (2, 2, 1) ("pod", "data", "model") mesh,
the reference test's case (reduced stablelm-3b at 4 layers, batch 4 x 32,
2 stages, 2 microbatches) in float32: each rank's ``pipeline_loss`` equals
``lm_loss(aux_weight=0)`` and its gradients (the rank's stage and the
replicated embedding and norm) autograd's, within relative 1e-5.  The
reference's own pipeline test fails on this tree (ROADMAP Queue 3), so the
pipeline is held to the port's unpipelined loss, which is held to the
reference's elsewhere.  The stage specs are the reference's but for its
dropped last axis (ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import reduced_config as ref_reduced
from repro.distributed import pipeline as RP
from repro.distributed import sharding as RS
from repro.models import init_lm as ref_init_lm
from repro_torch.configs import reduced_config
from repro_torch.distributed import pipeline as PP
from repro_torch.distributed import sharding as S
from repro_torch.models import init_lm
from repro_torch.train.train_step import TrainConfig, pipeline_train_step

from _torch_dist import run_worlds


def test_pipeline_world_of_four(tmp_path):
    out, = run_worlds([("pipeline", 4)], tmp_path)
    assert "OK pipeline rank 0" in out, out


def _strip(spec) -> tuple:
    """A spec without its trailing Nones (the reference pads a stage leaf's
    spec with them to the leaf's rank; a replicated spec is empty)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def test_stage_param_specs_match_the_reference():
    cfg = dataclasses.replace(reduced_config("stablelm-3b"), n_layers=4)
    rcfg = dataclasses.replace(ref_reduced("stablelm-3b"), n_layers=4)
    mesh = SimpleNamespace(axis_names=("pod", "data", "model"),
                           shape={"pod": 2, "data": 2, "model": 2})
    rules, rrules = S.rules_for(cfg, mesh), RS.rules_for(rcfg, mesh)
    staged = jax.eval_shape(lambda r: RP.split_stage_params(
        ref_init_lm(r, rcfg), 2), jax.random.PRNGKey(0))
    want = RP.stage_param_specs(staged, 2, rrules)
    flat = {RS._path_str(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, JP))[0]}
    model = init_lm(cfg, 0, "cpu")
    ndims = {n: p.ndim for n, p in model.named_parameters()}
    got = PP.stage_param_specs(model, 2, rules)
    for name, (stage, spec) in got.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            ref = tuple(flat["/".join(["groups", "0"] + parts[2:])])
            assert stage == int(parts[1]) // 2
            # the reference keeps the first ndim - 1 entries of the stage
            # leaf's spec, (None, None) + the layer's, which drops the
            # layer's last axis (ROADMAP Queue 3); the port keeps the
            # layer's spec whole
            layer = [None] * (ndims[name] - len(spec)) + list(spec)
            ndim = ndims[name] + 2
            kept = ([None, None] + layer + [None] * ndim)[:ndim - 1]
            assert ref == ("pod", *kept), (name, ref, spec)
        else:
            assert stage is None
            assert _strip(flat["/".join(parts)]) == _strip(spec), name


def test_split_stage_params():
    cfg = dataclasses.replace(reduced_config("stablelm-3b"), n_layers=4)
    model = init_lm(cfg, 0, "cpu")
    stages = PP.split_stage_params(model, 2)
    assert [(s.lo, s.hi) for s in stages] == [(0, 2), (2, 4)]
    assert stages[1].blocks[0] is model.blocks[2]
    assert stages[0].embed is stages[1].embed is model.embed
    with pytest.raises(ValueError):          # 4 layers, 3 stages
        PP.split_stage_params(model, 3)
    with pytest.raises(ValueError):          # not one ATTN scan group
        PP.split_stage_params(init_lm(reduced_config("zamba2-7b"), 0,
                                      "cpu"), 2)


def test_pipeline_train_step_is_a_stub():
    with pytest.raises(NotImplementedError, match="pipeline_loss"):
        pipeline_train_step(None, None, None, None, TrainConfig(), None, 2)
