"""The port's train step, optimizer and training loop on the CPU.

The counterparts of ``tests/test_train_fault.py``: the WSD schedule, the
pipeline's determinism and shards, atomic checkpoints that survive a
corrupt save, resume = straight run, NaN rollback, stragglers, int8
compression with error feedback (elastic resharding is not ported).  What
the port adds: one train step on every arch's reduced config; a
checkpoint round trip bit for bit (bf16 included); a ``save_async``
snapshot that an in-place step right after the call does not change; a
rollback that restores the model and optimizer state in place, exactly;
``compressed_psum`` over a one-process ``gloo`` group; the example.
Against the JAX package: ``batch_for_step`` and the stochastic rounding
on the reference's own noise bit for bit; ``wsd_lr`` for every schedule;
``adamw_update`` from identical gradients and three train steps from the
reference's initial state on its batches, in float32 within relative
1e-4.

AdamW moves an entry by up to lr whatever its gradient's size, so an
entry whose gradient is rounding noise (a few 1e-9 against a largest of
5e-2) moves by a noise-driven amount in each package, and the next step's
gradients differ by more than rounding: two runs' parameters drift apart
in their least-determined entries.  So the train steps are compared in
two ways: run freely, the metrics of each step (loss, grad_norm, lr);
and each step from the reference's state before it (carried across), the
whole state after it a leaf, except parameter entries whose gradient RMS
(``sqrt(nu)``) is under ``NOISE`` times the largest, which are held
within the 2 * lr by which two Adam updates can differ.
``adamw_update`` itself is held on every entry, from identical
gradients."""

import dataclasses
import importlib.util
import json
import os
import pathlib
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_models import TOL, np_tree, rel
from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig, \
    batch_for_step as jbatch_for_step
from repro.models import init_lm as jinit_lm
from repro.train.optimizer import OptConfig as JOptConfig, \
    adamw_update as jadamw_update, init_opt_state as jinit_opt_state, \
    wsd_lr as jwsd_lr
from repro.train.train_step import TrainConfig as JTrainConfig, \
    train_step as jtrain_step
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, batch_for_step
from repro_torch.distributed.compression import (compressed_psum,
                                                 dequantize_int8,
                                                 quantize_int8,
                                                 stochastic_round)
from repro_torch.interop import lm_params_from_jax, opt_state_from_jax
from repro_torch.launch.train import train_loop
from repro_torch.models import LM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import FaultConfig, StepTimer
from repro_torch.train.optimizer import OptConfig, adamw_update, wsd_lr
from repro_torch.train.train_step import TrainConfig, make_train_state, \
    train_step

CFG = reduced_config("qwen2-1.5b")
TCFG = TrainConfig(microbatches=2,
                   opt=OptConfig(peak_lr=1e-3, warmup_steps=2,
                                 stable_steps=10, decay_steps=4))
DCFG = DataConfig(seq_len=32, global_batch=4, vocab_size=CFG.vocab_size)
S = 17            # the parity runs' sequence length
NOISE = 1e-4
OPT = dict(peak_lr=1e-3, warmup_steps=2, stable_steps=2, decay_steps=2)


def _state():
    return make_train_state(CFG, 0, "cpu")


def _flat_state(params, opt) -> dict:
    out = {f"p/{k}": v.detach().clone() for k, v in
           params.state_dict().items()}
    for part in ("mu", "nu"):
        out.update({f"{part}/{k}": v.clone() for k, v in opt[part].items()})
    out["step"] = opt["step"].clone()
    return out


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the reference's tests, ported
# ---------------------------------------------------------------------------


def test_wsd_schedule_shape():
    oc = OptConfig(peak_lr=1.0, warmup_steps=10, stable_steps=20,
                   decay_steps=10, min_lr_frac=0.1)
    lrs = [float(wsd_lr(oc, s)) for s in [0, 5, 10, 25, 35, 40, 100]]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0) and lrs[3] == pytest.approx(1.0)
    assert 0.1 < lrs[4] < 1.0
    assert lrs[-1] == pytest.approx(0.1)


def test_data_pipeline_deterministic_and_shardable():
    b1 = batch_for_step(DCFG, 7)
    b2 = batch_for_step(DCFG, 7)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    shards = [batch_for_step(DCFG, 7, shard=i, n_shards=2)["tokens"]
              for i in range(2)]
    assert np.array_equal(np.concatenate(shards), b1["tokens"])
    pf = Prefetcher(DCFG, start_step=3)
    s, b = pf.next()
    assert s == 3 and np.array_equal(b["tokens"],
                                     batch_for_step(DCFG, 3)["tokens"])
    pf.close()


def test_checkpoint_atomic_and_corruption_tolerant(tmp_path):
    d = str(tmp_path)
    params, opt = _state()
    ckpt.save(d, 10, params, opt)
    ckpt.save(d, 20, params, opt)
    # a crashed half-save must be ignored
    os.makedirs(os.path.join(d, "step_0000000030"))
    with open(os.path.join(d, "step_0000000030", "manifest.json"), "w") as f:
        f.write("{corrupt")
    assert ckpt.latest_step(d) == 20
    want = _flat_state(params, opt)
    p2, o2 = _state()
    with torch.no_grad():
        for t in p2.parameters():
            t.add_(1.0)
    p2, o2, mf = ckpt.restore(d, 20, p2, o2)
    assert mf["step"] == 20 and mf["complete"]
    _assert_same(want, _flat_state(p2, o2))
    # keep=3: the oldest goes
    for s in (30, 40):
        ckpt.save(d, s, params, opt)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == [
        "step_0000000020", "step_0000000030", "step_0000000040"]


def test_resume_is_deterministic(tmp_path):
    """Train 8 steps straight vs 4 steps + restart + 4 steps: identical
    (bit for bit on the CPU)."""
    fc = FaultConfig(checkpoint_every=4)
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    r1 = train_loop(CFG, TCFG, DCFG, fc, steps=8, ckpt_dir=d1, log_every=100,
                    device="cpu")
    train_loop(CFG, TCFG, DCFG, fc, steps=4, ckpt_dir=d2, log_every=100,
               device="cpu")
    r2 = train_loop(CFG, TCFG, DCFG, fc, steps=8, ckpt_dir=d2, log_every=100,
                    device="cpu")
    assert r2.final_step == r1.final_step == 8
    assert r1.steps_run == 8 and r2.steps_run == 4
    assert [h["loss"] for h in r1.history[4:]] == \
        [h["loss"] for h in r2.history]
    states = []
    for d in (d1, d2):
        p, o = _state()
        ckpt.restore(d, 8, p, o)
        states.append(_flat_state(p, o))
    _assert_same(*states)


def test_nan_rollback(tmp_path):
    """A NaN at step 5 rolls back to the step-3 checkpoint, skips past it
    (the reference's rule: the step after the checkpoint's) and finishes;
    the live state is the last checkpoint's."""
    fc = FaultConfig(checkpoint_every=3, max_rollbacks=2)
    params, opt = _state()
    r = train_loop(CFG, TCFG, DCFG, fc, steps=8, ckpt_dir=str(tmp_path),
                   inject_nan_at=5, log_every=100, device="cpu",
                   state=(params, opt))
    assert r.rollbacks == 1
    assert r.final_step == 8
    assert [h["step"] for h in r.history] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert int(opt["step"]) == 7      # 3 from the checkpoint, then 4 more
    p3, o3 = _state()
    ckpt.restore(str(tmp_path), 8, p3, o3)
    _assert_same(_flat_state(p3, o3), _flat_state(params, opt))


def test_rollback_restores_in_place(tmp_path):
    d = str(tmp_path)
    params, opt = _state()
    batch = {"tokens": torch.from_numpy(batch_for_step(DCFG, 0)["tokens"])}
    train_step(params, opt, batch, CFG, TCFG)
    ckpt.save(d, 1, params, opt)
    want = _flat_state(params, opt)
    ids = [id(t) for t in params.parameters()]
    train_step(params, opt, batch, CFG, TCFG)
    ckpt.restore(d, 1, params, opt)
    _assert_same(want, _flat_state(params, opt))
    assert [id(t) for t in params.parameters()] == ids
    assert all(t.requires_grad for t in params.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_every_arch(arch):
    """The reduced config as it is (bf16): a finite loss and gradient
    norm, and the parameters move."""
    cfg = reduced_config(arch)
    params, opt = make_train_state(cfg, 0, "cpu")
    before = {k: v.detach().clone() for k, v in params.named_parameters()}
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 9), dtype=np.int32))}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(
            rng.normal(0, 1, (2, 9, cfg.d_model)).astype(np.float32))
    tcfg = TrainConfig(microbatches=2, opt=OptConfig(
        peak_lr=1e-3, warmup_steps=2, stable_steps=2, decay_steps=2))
    _, _, m = train_step(params, opt, batch, cfg, tcfg)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    moved = [not torch.equal(before[k], v)
             for k, v in params.named_parameters()]
    assert sum(moved) > len(moved) // 2
    assert int(opt["step"]) == 1


def test_straggler_detector():
    timer = StepTimer(FaultConfig(straggler_window=16, straggler_sigma=3.0))
    rng = np.random.default_rng(0)
    for i in range(20):
        assert not timer.record(i, 0.1 + 1e-4 * rng.random())
    assert timer.record(99, 1.5)
    assert timer.events and timer.events[0]["step"] == 99


def test_compressed_psum_error_feedback():
    """int8 quantization with error feedback: the cumulative quantized sum
    plus the residual equals the true sum."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(512, generator=gen) * 3.0
    q, scale = quantize_int8(x, torch.Generator().manual_seed(1))
    assert q.dtype == torch.int8
    deq = dequantize_int8(q, scale)
    assert float((deq - x).abs().max()) <= float(scale) * 1.0 + 1e-6
    total_true = torch.zeros_like(x)
    total_q = torch.zeros_like(x)
    residual = torch.zeros_like(x)
    noise = torch.Generator().manual_seed(100)
    for i in range(20):
        g = torch.randn(512, generator=torch.Generator().manual_seed(i))
        total_true = total_true + g
        q, scale = quantize_int8(g + residual, noise)
        sent = dequantize_int8(q, scale)
        residual = g + residual - sent
        total_q = total_q + sent
    drift = float((total_q + residual - total_true).abs().max())
    assert drift < 1e-3


# ---------------------------------------------------------------------------
# against the reference, and what the port adds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step,shard,n_shards,frames",
                         [(0, 0, 1, 0), (7, 1, 2, 0), (123, 3, 4, 16)])
def test_batch_for_step_matches_reference(step, shard, n_shards, frames):
    kw = dict(seq_len=24, global_batch=8, vocab_size=1000, seed=77,
              frames_dim=frames)
    got = batch_for_step(DataConfig(**kw), step, shard, n_shards)
    want = jbatch_for_step(JDataConfig(**kw), step, shard, n_shards)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_checkpoint_round_trip_bitwise(tmp_path):
    """bf16 params (as uint16 bits under ``__bf16`` keys), f32 moments and
    the int32 step, bit for bit; the files hold the reference's layout."""
    params, opt = _state()
    batch = {"tokens": torch.from_numpy(batch_for_step(DCFG, 0)["tokens"])}
    train_step(params, opt, batch, CFG, TCFG)
    d = ckpt.save(str(tmp_path), 1, params, opt, meta={"arch": CFG.name})
    with np.load(os.path.join(d, "params.npz")) as f:
        assert "embed.embed__bf16" in f and f["embed.embed__bf16"].dtype == \
            np.uint16
    with np.load(os.path.join(d, "opt.npz")) as f:
        assert f["step"].dtype == np.int32 and int(f["step"]) == 1
        assert "mu/embed.embed" in f and "nu/final_norm.scale" in f
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f) == {"step": 1, "meta": {"arch": CFG.name},
                                "complete": True}
    p2, o2 = _state()
    ckpt.restore(str(tmp_path), 1, p2, o2, device="cpu")
    _assert_same(_flat_state(params, opt), _flat_state(p2, o2))


def test_save_async_snapshot_is_a_copy(tmp_path):
    """The async save writes the state of the call, even when the next
    step updates the CPU tensors in place before the writer runs."""
    params, opt = _state()
    want = _flat_state(params, opt)
    t = ckpt.save_async(str(tmp_path), 1, params, opt)
    batch = {"tokens": torch.from_numpy(batch_for_step(DCFG, 0)["tokens"])}
    train_step(params, opt, batch, CFG, TCFG)
    t.join(timeout=60)
    assert not t.is_alive()
    p2, o2 = _state()
    with torch.no_grad():
        for x in p2.parameters():
            x.add_(1.0)
    ckpt.restore(str(tmp_path), 1, p2, o2)
    _assert_same(want, _flat_state(p2, o2))
    assert not torch.equal(want["p/embed.embed"], params.embed.embed)


def test_stochastic_round_matches_reference_formula():
    """The rounding step on the reference's own noise (a JAX key's uniform
    draw): the reference's expression bit for bit."""
    x = jax.random.normal(jax.random.PRNGKey(3), (4096,)) * 5.0
    xf = x.astype(jnp.float32)
    scale = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-12) / 127.0
    y = xf / scale
    noise = jax.random.uniform(jax.random.PRNGKey(4), y.shape) - 0.5
    want = np.asarray(jnp.clip(jnp.round(y + noise), -127, 127))
    got = stochastic_round(torch.from_numpy(np.array(y)),
                           torch.from_numpy(np.array(noise)))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compressed_psum_one_process_group():
    """A world of one over gloo: the sum is the dequantized payload, and
    payload + residual is the input."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        gen = torch.Generator().manual_seed(5)
        x = torch.randn(1000, generator=gen)
        residual = torch.randn(1000, generator=gen) * 1e-3
        total, new_res = compressed_psum(x, dist.group.WORLD,
                                         torch.Generator().manual_seed(6),
                                         residual)
        xf = x + residual
        scale = float(xf.abs().max()) / 127.0
        assert torch.allclose(total + new_res, xf, atol=1e-6)
        q = total / scale
        assert float((q - q.round()).abs().max()) < 1e-3
        assert float((total - xf).abs().max()) <= scale + 1e-6
    finally:
        dist.destroy_process_group()


def test_example_trains_reloads_and_serves(capsys):
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    tokens = example.main(["--steps", "4", "--device", "cpu"])
    assert len(tokens) == 9 and all(0 <= t < CFG.vocab_size for t in tokens)
    assert "checkpoint step 4" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------


def _params_rel(want: dict, got: dict, nu: dict, lr: float) -> float:
    """The worst relative error of the parameters a leaf, on the entries
    whose gradient RMS ``sqrt(nu)`` (the reference's) is at least
    ``NOISE`` times the largest; the other entries must be within
    2 * lr."""
    top = max(float(v.sqrt().max()) for v in nu.values())
    worst = 0.0
    for name, w in want.items():
        d = (w.float() - got[name].detach().float()).abs()
        well = nu[name].sqrt() >= NOISE * top
        if well.any():
            worst = max(worst, float(d[well].max() / w.abs().max()))
        if (~well).any():
            assert float(d[~well].max()) <= 2 * lr, name
    return worst


@pytest.fixture(scope="module")
def ref_init():
    """The reference's initial qwen2 state in f32 (its make_train_state:
    init_lm at PRNGKey(0)), made once (it takes seconds to compile)."""
    jcfg = dataclasses.replace(jconfigs.reduced_config("qwen2-1.5b"),
                               dtype="float32")
    return jcfg, jinit_lm(jax.random.PRNGKey(0), jcfg)


def _port(jp, tcfg) -> LM:
    model = LM(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(np_tree(jp), tcfg), strict=True)
    return model.requires_grad_(True)


def _ref_state(ref_init):
    """The reference's initial state and the port's copy of it."""
    jcfg, jp = ref_init
    tcfg = dataclasses.replace(reduced_config("qwen2-1.5b"), dtype="float32")
    jo = jinit_opt_state(jp)
    return jcfg, tcfg, jp, jo, _port(jp, tcfg), opt_state_from_jax(
        np_tree(jo), tcfg)


def test_adamw_update_matches_reference(ref_init):
    """The reference's gradients (seeded, f32) into both optimizers, twice:
    every parameter, moment and metric within 1e-4."""
    jcfg, tcfg, jp, jo, model, topt = _ref_state(ref_init)
    rng = np.random.default_rng(11)
    jupdate = jax.jit(lambda p, g, o: jadamw_update(JOptConfig(**OPT), p, g,
                                                    o))
    for step in range(2):
        jg = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(0, 1e-2, x.shape)
                                  .astype(np.float32)), jp)
        jp, jo, jm = jupdate(jp, jg, jo)
        _, _, tm = adamw_update(OptConfig(**OPT), model,
                                lm_params_from_jax(np_tree(jg), tcfg), topt)
        for key in ("lr", "grad_norm"):
            assert rel(jm[key], tm[key]) < TOL, key
        want = opt_state_from_jax(np_tree(jo), tcfg)
        got = dict(model.named_parameters())
        for name, w in lm_params_from_jax(np_tree(jp), tcfg).items():
            assert rel(w, got[name]) < TOL, name
            for part in ("mu", "nu"):
                assert rel(want[part][name], topt[part][name]) < TOL
        assert int(topt["step"]) == step + 1


def test_three_train_steps_match_reference(ref_init):
    """From the reference's initial state (weights and optimizer state
    carried across), three steps on the reference pipeline's batches, two
    microbatches each: run freely, each step's metrics; each step started
    from the reference's state, the whole state after it."""
    jcfg, tcfg, jp, jo, model, topt = _ref_state(ref_init)
    forced, forced_opt = _port(jp, tcfg), opt_state_from_jax(np_tree(jo),
                                                              tcfg)
    jtc = JTrainConfig(microbatches=2, opt=JOptConfig(**OPT))
    ttc = TrainConfig(microbatches=2, opt=OptConfig(**OPT))
    dcfg = JDataConfig(seq_len=S, global_batch=4, vocab_size=jcfg.vocab_size)
    jstep = jax.jit(lambda p, o, b: jtrain_step(p, o, b, jcfg, jtc))
    for step in range(3):
        tokens = jbatch_for_step(dcfg, step)["tokens"]
        with torch.no_grad():
            forced.load_state_dict(lm_params_from_jax(np_tree(jp), tcfg))
        forced_opt = opt_state_from_jax(np_tree(jo), tcfg)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(tokens)})
        _, _, tm = train_step(model, topt, {"tokens": torch.from_numpy(
            tokens)}, tcfg, ttc)
        _, _, fm = train_step(forced, forced_opt, {"tokens": torch.from_numpy(
            tokens)}, tcfg, ttc)
        for key in ("loss", "grad_norm", "lr"):
            assert rel(jm[key], tm[key]) < TOL, (step, key)
            assert rel(jm[key], fm[key]) < TOL, (step, key)
        want_o = opt_state_from_jax(np_tree(jo), tcfg)
        for part in ("mu", "nu"):
            for name, w in want_o[part].items():
                assert rel(w, forced_opt[part][name]) < TOL, (step, part,
                                                             name)
        assert _params_rel(lm_params_from_jax(np_tree(jp), tcfg),
                           dict(forced.named_parameters()), want_o["nu"],
                           float(jm["lr"])) < TOL, step
        for opt in (topt, forced_opt):
            assert int(opt["step"]) == int(jo["step"]) == step + 1
            assert opt["step"].dtype == torch.int32


@pytest.mark.parametrize("schedule", ["wsd", "cosine", "const"])
def test_wsd_lr_matches_reference(schedule):
    kw = dict(peak_lr=1.0, warmup_steps=10, stable_steps=20, decay_steps=10,
              min_lr_frac=0.1, schedule=schedule)
    for s in [0, 5, 10, 25, 35, 40, 100]:
        want = float(jwsd_lr(JOptConfig(**kw), jnp.asarray(s)))
        got = wsd_lr(OptConfig(**kw), torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=TOL, abs=1e-7), s
