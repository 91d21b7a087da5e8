"""The port's dry run (``repro_torch.launch.dryrun``), its counting
(``launch.analysis``) and the remat policies (``models.lm``).

The dry run builds every cell from fake tensors over a fake process group
in a process of its own: here a reduced config's train, prefill and
decode cells on a (2, 2) mesh (a fake world of 4).  The reference's
integration cells at full width on the production meshes (qwen2-1.5b
decode_32k on pod256: ok, per-rank bytes under one H100's 80 GB, memory
the dominant term; stablelm-3b decode_32k on pod512: ok; the reference's
own test fails on this tree, ROADMAP Queue 3) are ``chip_smoke.py``'s
distributed phase, for the time these take.

The remat policies give the same gradients; "dots" and "block_outs" keep
more bytes through the forward than "full".  Selective checkpointing keeps
its saved matmul outputs in a cache of its own, not through
``saved_tensors_hooks``, so the bytes are counted as those of the tensors
made in the forward that are still held when it returns
(``StepCounter.live_bytes``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro_torch.configs import reduced_config
from repro_torch.launch import analysis as A
from repro_torch.launch.mesh import H100
from repro_torch.models import init_lm, lm_loss
from repro_torch.models import lm as port_lm

ROOT = os.path.join(os.path.dirname(__file__), "..")
ART = os.path.join(ROOT, "experiments", "dryrun_torch")


def _dryrun(*args, timeout=120) -> str:
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    return r.stdout


def _artifact(name: str) -> dict:
    with open(os.path.join(ART, name + ".json")) as f:
        return json.load(f)


def test_dryrun_reduced_cells_on_a_fake_world_of_four():
    out = _dryrun("--arch", "qwen2-1.5b", "--shape",
                  "train_4k,prefill_32k,decode_32k", "--reduced", "--mesh",
                  "2,2", "--seq-len", "32", "--global-batch", "4",
                  "--microbatches", "1", "--variant", "pytest")
    assert out.count("[OK ]") == 3, out
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        art = _artifact(f"qwen2-1.5b__{shape}__2x2__pytest")
        assert art["ok"] and art["mesh_shape"] == {"data": 2, "model": 2}
        assert (art["seq_len"], art["global_batch"]) == (32, 4)
        mem = art["memory"]
        assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
        # the model axis is 2: tensor parallelism all-reduces activations
        assert art["collectives"]["all-reduce"] > 0, art["collectives"]
        raw = art["roofline_hlo_raw"]
        assert raw["flops_per_chip"] > 0 and raw["hbm_bytes_per_chip"] > 0
        assert art["roofline"]["source"] == "analytic"
        assert art["roofline"]["hardware"]["hbm_bw"] == H100.hbm_bw
    train = _artifact("qwen2-1.5b__train_4k__2x2__pytest")
    # ZeRO: the gradients reduce-scatter over the data axis
    assert train["collectives"]["reduce-scatter"] > 0


def test_collective_bytes():
    recs = [("all-reduce", 256 * 4096 * 4), ("all-gather", 32 * 1024 * 2),
            ("collective-permute", 8 * 4)]
    out = A.collective_bytes(recs)
    assert out["all-reduce"] == 256 * 4096 * 4
    assert out["all-gather"] == 32 * 1024 * 2
    assert out["collective-permute"] == 8 * 4
    assert out["reduce-scatter"] == out["all-to-all"] == 0
    assert out["count"] == 3
    kinds = {"_c10d_functional.all_gather_into_tensor.default": "all-gather",
             "_c10d_functional.reduce_scatter_tensor.default":
                 "reduce-scatter",
             "_c10d_functional.all_reduce.default": "all-reduce",
             "_c10d_functional.all_to_all_single.default": "all-to-all",
             "c10d.send.default": "collective-permute",
             "_c10d_functional.wait_tensor.default": None,
             "aten.mm.default": None}
    assert {k: A._op_kind(k) for k in kinds} == kinds


def test_step_counter_counts_flops_bytes_and_peak():
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    with A.StepCounter() as c:
        c.hold([a, b])
        y = a @ b
        z = (y * 2).sum()
        del y
    assert c.flops == 2 * 4 * 8 * 16
    assert c.bytes_accessed == (32 + 128 + 64) * 4 + (64 + 64) * 4 + \
        (64 + 1) * 4
    assert c.peak_bytes == 2 * 64 * 4 + 4 and c.live_bytes == 4
    assert float(z) == 4 * 16 * 16
    assert A.collective_bytes(c.records)["count"] == 0


_RANK_LOCAL = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.distributed.sharding import NamedSharding, P, distribute
from repro_torch.launch.analysis import StepCounter, collective_bytes
from repro_torch.launch.mesh import make_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
x = distribute(torch.ones(8, 16), NamedSharding(mesh, P("data", None)))
w = distribute(torch.ones(16, 32), NamedSharding(mesh, P(None, "model")))
w2 = distribute(torch.ones(32, 16), NamedSharding(mesh, P("model", None)))
out = []
for _ in range(2):     # shapes propagated on the first pass, cached after
    with StepCounter() as c:
        z = ((x @ w) @ w2).redistribute(mesh, (Shard(0), Replicate()))
    out.append([c.flops, collective_bytes(c.records)])
x2 = distribute(torch.ones(8, 16), NamedSharding(mesh, P(None, "model")))
with FlopCounterMode(display=False) as fc:   # the same work, fresh shapes
    x2.redistribute(mesh, (Shard(0), Replicate())) @ w @ w2
print(json.dumps(out + [fc.get_total_flops()]))
"""


def test_step_counter_counts_rank_local_work_on_dtensors():
    """On a fake world of 4, a (data, model)-sharded pair of matmuls:
    rank 0's local FLOPs only (DTensor's shape propagation on the whole
    tensors skipped) and the all-reduce of its (4, 16) float32 shard;
    ``FlopCounterMode`` on the same work counts more."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run([sys.executable, "-c", _RANK_LOCAL], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-4000:]
    first, again, whole = json.loads(r.stdout.strip().splitlines()[-1])
    assert first == again
    flops, coll = first
    assert flops == 2 * (2 * 4 * 16 * 16)
    assert coll["all-reduce"] == 4 * 16 * 4 and coll["count"] == 1, coll
    # FlopCounterMode also counts the ops on the whole tensors (why the
    # counter keeps its own mode)
    assert whole > flops, whole


def test_remat_policy_names():
    assert port_lm.REMAT_POLICIES == ref_lm.REMAT_POLICIES
    with pytest.raises(ValueError):
        port_lm.set_remat_policy("everything")


def _loss_and_grads(policy: str, model, toks, cfg):
    port_lm.set_remat_policy(policy)
    try:
        with A.StepCounter() as c:
            c.hold(list(model.parameters()) + [toks])
            loss, _ = lm_loss(model, toks, cfg)
            held = c.live_bytes
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        port_lm.set_remat_policy("full")
    return float(loss), grads, held


@pytest.mark.parametrize("policy", ["dots", "block_outs"])
def test_remat_policies_same_gradients_more_saved(policy):
    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), dtype="float32")
    model = init_lm(cfg, 0, "cpu").requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)), dtype=torch.int32)
    loss_f, g_f, held_f = _loss_and_grads("full", model, toks, cfg)
    loss_p, g_p, held_p = _loss_and_grads(policy, model, toks, cfg)
    assert loss_p == loss_f
    for a, b in zip(g_p, g_f):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert held_p > held_f, (held_p, held_f)
