"""The port's launch specs and analytic roofline (``repro_torch.launch.
specs``, ``.analysis``, ``configs.all_cells``) against the JAX package's.

For every (arch, shape) cell on both production meshes (as mesh-like
objects: the functions read only axis names and sizes): ``batch_specs``
and ``cache_pspecs`` (the port's caches are the reference's tree) are
equal entry for entry, and ``analytic_roofline`` and ``model_flops`` equal
to the last bit when the port's ``Hardware`` carries the reference's own
constants, under every remat policy for a train cell and with an int8 KV
cache for a decode cell.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro import configs as rconfigs
from repro.distributed import sharding as RS
from repro.launch import analysis as RA
from repro.launch import mesh as RM
from repro.launch import specs as RSP
from repro_torch import configs
from repro_torch.distributed import sharding as S
from repro_torch.launch import analysis as A
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import H100, Hardware

MESHES = {"pod256": {"data": 16, "model": 16},
          "pod512": {"pod": 2, "data": 16, "model": 16}}
#: the reference's TPU constants, carried into the port's Hardware so the
#: two rooflines can be compared bit for bit
REF_HW = Hardware(name="reference", peak_flops_bf16=RM.PEAK_FLOPS_BF16,
                  hbm_bw=RM.HBM_BW, hbm_bytes=RM.HBM_BYTES,
                  link_bw=RM.ICI_BW)


def mesh_like(name: str) -> SimpleNamespace:
    shape = MESHES[name]
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def as_tuples(tree):
    """A reference spec tree with PartitionSpecs as tuples."""
    return jax.tree_util.tree_map(tuple, tree,
                                  is_leaf=lambda x: isinstance(x, JP))


def test_all_cells_and_shapes():
    assert configs.all_cells() == rconfigs.all_cells()
    assert len(configs.all_cells()) == 32
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in rconfigs.SHAPES.items()}


def test_h100_constants():
    """The port's roofline denominators are one H100 SXM's data-sheet
    figures, none of the reference's TPU numbers."""
    assert (H100.peak_flops_bf16, H100.hbm_bw, H100.hbm_bytes,
            H100.link_bw) == (989.4e12, 3.35e12, 80e9, 50e9)
    tpu = {RM.PEAK_FLOPS_BF16, RM.HBM_BW, RM.HBM_BYTES}
    assert not tpu & {H100.peak_flops_bf16, H100.hbm_bw, H100.hbm_bytes}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("cell", configs.all_cells(),
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_cell_specs_and_roofline(cell, mesh):
    arch, shape = cell
    cfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    sc, rsc = configs.SHAPES[shape], rconfigs.SHAPES[shape]
    m = mesh_like(mesh)
    rules, rrules = S.rules_for(cfg, m), RS.rules_for(rcfg, m)
    dp = m.shape["data"] * m.shape.get("pod", 1)

    shapes, specs, ok = SP.batch_specs(cfg, sc, rules, dp)
    rshapes, rspecs, rok = RSP.batch_specs(rcfg, rsc, rrules, dp)
    assert ok == rok
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in rspecs.items()}
    assert {k: v.shape for k, v in shapes.items()} == \
        {k: tuple(v.shape) for k, v in rshapes.items()}
    for shardable in (True, False):
        assert SP.cache_pspecs(cfg, rules, shardable) == as_tuples(
            RSP.cache_pspecs(rcfg, rrules, shardable))
    assert SP.mamba_nh_shardable(cfg, rules) == \
        RSP.mamba_nh_shardable(rcfg, rrules)

    n = 512 if mesh == "pod512" else 256
    assert A.model_flops(cfg, sc, n) == RA.model_flops(rcfg, rsc, n)
    runs = [("full", None, None)]
    if sc.kind == "train":
        runs += [("dots", None, None), ("block_outs", None, None),
                 ("full", "int8", None)]
    if sc.kind == "decode":
        runs += [("full", None, "int8")]
    for remat, comp, kv in runs:
        c, rc = cfg, rcfg
        if kv:
            c = dataclasses.replace(cfg, kv_cache_dtype=kv)
            rc = dataclasses.replace(rcfg, kv_cache_dtype=kv)
        rules.grad_compression = rrules.grad_compression = comp
        mb = max(1, min(16, sc.global_batch // dp))
        got = A.analytic_roofline(c, sc, m, rules, microbatches=mb,
                                  remat_policy=remat, hw=REF_HW)
        want = RA.analytic_roofline(rc, rsc, m, rrules, microbatches=mb,
                                    remat_policy=remat)
        assert {k: got[k] for k in want} == want, (remat, comp, kv)
        assert got["hardware"]["name"] == "reference"


def test_roofline_terms_use_the_hardware():
    r = A.Roofline(flops=989.4e12, hbm_bytes=3.35e12 / 2, coll_bytes=0.0,
                   model_flops_per_chip=989.4e12 / 2)
    assert (r.compute_s, r.memory_s, r.dominant) == (1.0, 0.5, "compute")
    assert r.mfu_upper_bound == 0.5 and r.useful_flops_ratio == 0.5
    ref = A.Roofline(1.0, 1.0, 1.0, 1.0, hw=REF_HW)
    assert ref.as_dict() == RA.Roofline(1.0, 1.0, 1.0, 1.0).as_dict()
