"""One rank of the CPU worlds (gloo) that ``tests/test_torch_sharding.py``
and ``tests/test_torch_pipeline.py`` start (:func:`run_worlds`), a process
a rank:

    python tests/_torch_dist.py CASE RANK WORLD PORT TMPDIR

CASE ``train``: the sharded train step (DTensor parameters by
``params_shardings``, ZeRO optimizer state, ``grad_pspecs``) on every mesh
of the world's size, reduced configs in float32, against the same step in
one process: loss, the accumulated gradients, mu and nu within relative
1e-5, the updated parameters within 1e-5; a decode step over caches whose
sequence is sharded (``kv_seq``), logits and caches within relative 1e-5;
and (world 2) a checkpoint saved
unsharded and restored onto the (1, 2) mesh with ``shardings=``, bit for
bit.
CASE ``pipeline``: ``pipeline_loss`` of reduced stablelm-3b at 4 layers on
a (2, 2, 1) mesh, 2 microbatches, against ``lm_loss(aux_weight=0)`` and
its autograd gradients, float32, relative 1e-5.  Every rank checks its
own part and exits non-zero on a mismatch; rank 0 prints the errors.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import socket
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.distributed.pipeline import (  # noqa: E402
    pipeline_loss, split_stage_params, stage_param_specs)
from repro_torch.distributed.sharding import (  # noqa: E402
    P, NamedSharding, distribute, distribute_opt_state, distribute_params,
    params_shardings, placements, rules_for, use_rules, zero_pspecs)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import (  # noqa: E402
    cache_pspecs, distribute_tree, named)
from repro_torch.models import (  # noqa: E402
    init_lm, lm_decode, lm_loss, lm_prefill)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    OptConfig, adamw_update, init_opt_state)
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig, accumulate_grads, make_train_state, train_step)

TOL = 1e-5
#: step 1's learning rate is 1e-6: Adam moves every entry by about lr, and
#: entries whose gradient is rounding noise may flip sign between two
#: summation orders, so parameters stay within 2e-6 of each other
OPT = OptConfig(peak_lr=1e-3, warmup_steps=1000)
#: (arch, config changes, microbatches, tolerance).  Reduced qwen2 with
#: one KV head leaves the KV heads unsharded, so attention shards the
#: query sequence over 'model' (``scores_q``) with each rank's causal
#: offset.  The Mamba2 hybrid and xLSTM are held at the port's float32
#: family tolerance, 1e-4 (``tests/_torch_models.py``): local products
#: over half the batch round otherwise, and the SSD's exponentials of
#: running sums carry that to 3e-6 .. 1.4e-5
KV1 = {"n_kv_heads": 1}
TRAIN_WORLD = {2: (("qwen2-1.5b", {}, 2, TOL), ("qwen2-1.5b", KV1, 2, TOL)),
               4: (("qwen2-1.5b", {}, 2, TOL), ("qwen2-1.5b", KV1, 2, TOL),
                   ("deepseek-moe-16b", {}, 2, TOL),
                   ("zamba2-7b", {}, 2, 1e-4),
                   ("xlstm-1.3b", {}, 2, 1e-4))}
#: (mesh, the int8 gradient-compression flag): the flag is the reference's
#: accounting flag (the analytic roofline's), so the step is the same
MESHES = {2: (((2, 1), "int8"), ((1, 2), None)), 4: (((2, 2), None),)}


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    if isinstance(got, DTensor):
        got = got.full_tensor()
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def check(what: str, err: float, tol: float = TOL) -> float:
    if not err <= tol:
        raise AssertionError(f"{what}: {err} > {tol}")
    return err


def sharded_step(arch: str, changes: dict, mb: int, tol: float,
                 shape: tuple, compression) -> dict:
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              **changes)
    if changes:
        arch += str(changes)
    tcfg = TrainConfig(microbatches=mb, opt=OPT)
    data = DataConfig(seq_len=17, global_batch=8, vocab_size=cfg.vocab_size)
    batch = {k: torch.as_tensor(v) for k, v in batch_for_step(data, 0).items()}
    plain, popt = make_train_state(cfg, 0, "cpu")
    model = copy.deepcopy(plain)
    want_g, want_m = accumulate_grads(plain, batch, cfg, tcfg)
    adamw_update(tcfg.opt, plain, want_g, popt)    # train_step's second half

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    rules = rules_for(cfg, mesh)
    rules.grad_compression = compression
    if changes is KV1 and shape[1] > 1 and rules.axis("scores_q") != "model":
        raise AssertionError(f"scores_q {rules.axis('scores_q')}")
    distribute_params(model, params_shardings(model, mesh, rules))
    zs = zero_pspecs(model, rules, mesh)
    opt = distribute_opt_state(init_opt_state(model), named(zs, mesh))
    bt = {k: distribute(v, NamedSharding(mesh, P(rules.axis("batch"), None)))
          for k, v in batch.items()}
    with use_rules(rules):
        if compression:      # the whole train_step once (an accounting flag)
            _, _, m = train_step(copy.deepcopy(model), copy.deepcopy(opt),
                                 bt, cfg, tcfg, grad_pspecs=zs)
            check(f"{arch} {shape} train_step loss",
                  rel(m["loss"], want_m["loss"]), tol)
        got_g, got_m = accumulate_grads(model, bt, cfg, tcfg, grad_pspecs=zs)
        adamw_update(tcfg.opt, model, got_g, opt)
    out = {"loss": check(f"{arch} {shape} loss",
                         rel(got_m["loss"], want_m["loss"]), tol)}
    for n, g in got_g.items():
        if tuple(g.placements) != placements(zs[n], mesh):
            raise AssertionError(f"{arch} {shape}: {n}'s accumulator is "
                                 f"{g.placements}, not ZeRO {zs[n]}")
    out["grads"] = check(f"{arch} {shape} grads", max(
        rel(g, want_g[n]) for n, g in got_g.items()), tol)
    for part in ("mu", "nu"):
        out[part] = check(f"{arch} {shape} {part}", max(
            rel(t, popt[part][n]) for n, t in opt[part].items()), tol)
    # absolute: a zero-initialised bias moves by about lr, so its own
    # largest entry is no scale for it
    want_p = dict(plain.named_parameters())
    out["params"] = check(f"{arch} {shape} params", max(
        float((p.full_tensor() - want_p[n]).abs().max())
        for n, p in model.named_parameters()))
    if int(opt["step"]) != 1:
        raise AssertionError(f"{arch} {shape}: step {int(opt['step'])}")
    return out


def sharded_decode(shape: tuple, batch: int = 4) -> dict:
    """One decode step of reduced qwen2 (f32) with a single KV head, so
    the rules shard the caches' sequence over 'model' (``kv_seq``): the
    sharded step writes each rank's rows and combines the softmax across
    ranks.  Logits and every cache leaf against the unsharded step.  A
    batch that the data axis does not divide leaves uneven shards (the
    embedding's tokens, the caches' rows), whose regions must keep the
    global shapes."""
    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), dtype="float32",
                              n_kv_heads=1)
    model = init_lm(cfg, 0, "cpu")
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, 12)))
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, 1)))
    clen = torch.tensor([12, 5, 9, 12][:batch], dtype=torch.int32)
    with torch.no_grad():
        _, caches = lm_prefill(model, toks, cfg, max_seq=16)
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        rules = rules_for(cfg, mesh)
        if rules.axis("kv_seq") != "model":
            raise AssertionError(f"kv_seq {rules.axis('kv_seq')}")
        dcaches = distribute_tree(copy.deepcopy(caches),
                                  cache_pspecs(cfg, rules, True), mesh)
        want, caches = lm_decode(model, nxt, caches, clen, cfg)
        distribute_params(model, params_shardings(model, mesh, rules))
        bspec = rules.axis("batch")
        with use_rules(rules):
            got, dcaches = lm_decode(
                model, distribute(nxt, NamedSharding(mesh, P(bspec, None))),
                dcaches, distribute(clen, NamedSharding(mesh, P(bspec))),
                cfg)
    leaves = lambda t: [x for g in t for x in (  # noqa: E731
        g.values() if isinstance(g, dict) else g)]
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"decode {shape} batch {batch}: logits "
                             f"{tuple(got.shape)}, not {tuple(want.shape)}")
    return {"logits": check(f"decode {shape} logits", rel(got, want)),
            "caches": check(f"decode {shape} caches", max(
                rel(a, b) for a, b in zip(leaves(dcaches), leaves(caches))))}


def elastic(tmp: str, shape: tuple) -> None:
    """Save unsharded (rank 0), restore onto ``shape`` with shardings."""
    cfg = reduced_config("qwen2-1.5b")
    params, opt = make_train_state(cfg, 0, "cpu")
    d = os.path.join(tmp, "elastic")
    if dist.get_rank() == 0:
        ckpt.save(d, 1, params, opt)
    dist.barrier()
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    rules = rules_for(cfg, mesh)
    p2, o2 = make_train_state(cfg, 1, "cpu")
    zsh = named(zero_pspecs(p2, rules, mesh), mesh)
    ckpt.restore(d, 1, p2, o2, shardings=(params_shardings(p2, mesh, rules),
                                          {"mu": zsh, "nu": zsh}))
    want = dict(params.named_parameters())
    for n, p in p2.named_parameters():
        if not isinstance(p, DTensor) or not p.requires_grad \
                or not torch.equal(p.full_tensor(), want[n]):
            raise AssertionError(f"elastic {shape}: {n}")
    for part in ("mu", "nu"):
        for n, t in o2[part].items():
            if not isinstance(t, DTensor) or \
                    not torch.equal(t.full_tensor(), opt[part][n]):
                raise AssertionError(f"elastic {shape}: {part} {n}")
    if int(o2["step"]) != int(opt["step"]):
        raise AssertionError("elastic: step")


def pipeline() -> dict:
    cfg = dataclasses.replace(reduced_config("stablelm-3b"), n_layers=4,
                              dtype="float32")
    model = init_lm(cfg, 0, "cpu").requires_grad_(True)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 32)), dtype=torch.int32)
    names = [n for n, _ in model.named_parameters()]
    piped = copy.deepcopy(model)
    ref, _ = lm_loss(model, toks, cfg, aux_weight=0.0, remat=False)
    want = dict(zip(names, torch.autograd.grad(ref, list(
        model.parameters()))))
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    rules = rules_for(cfg, mesh)
    loss = pipeline_loss(split_stage_params(piped, 2), toks, cfg, mesh,
                         n_micro=2, rules=rules)
    stage = mesh.get_coordinate()[0]
    mine = [n for n, (s, _) in stage_param_specs(piped, 2, rules).items()
            if s in (None, stage)]
    got = dict(piped.named_parameters())
    return {"loss": check("pipeline loss", rel(loss, ref)),
            "grads": check("pipeline grads", max(
                rel(got[n].grad, want[n]) for n in mine)),
            "params_checked": len(mine)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_worlds(worlds, tmp, timeout: float = 240) -> list[str]:
    """This script's cases as gloo worlds, all at once: ``worlds`` holds
    (case, world size) pairs, a process a rank (one thread each).  Returns
    each world's rank-0 output, failing with every rank's on a non-zero
    exit or a process past ``timeout`` seconds (all are killed then)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": SRC}
    procs = []
    for case, world in worlds:
        port = _free_port()
        procs.append([subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r),
             str(world), str(port), str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world)])
    flat = [p for ps in procs for p in ps]
    outs = {}
    try:
        for p in flat:
            outs[p] = p.communicate(timeout=timeout)[0]
    finally:
        for p in flat:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not any(p.returncode for p in flat), \
        "\n".join(o[-3000:] for o in outs.values())
    return [outs[ps[0]] for ps in procs]


def main() -> None:
    case, rank, world, port, tmp = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        if case == "train":
            for shape, comp in MESHES[world]:
                for arch, changes, mb, tol in TRAIN_WORLD[world]:
                    t0 = time.perf_counter()
                    out = sharded_step(arch, changes, mb, tol, shape, comp)
                    if rank == 0:
                        print("OK train", arch, changes or "", shape, comp, out,
                              f"{time.perf_counter() - t0:.2f} s",
                              flush=True)
            last = MESHES[world][-1][0]
            for batch in (4, 3):
                out = sharded_decode(last, batch)
                if rank == 0:
                    print("OK decode", last, batch, out, flush=True)
            if world == 2:
                elastic(tmp, last)
                if rank == 0:
                    print("OK elastic", last, flush=True)
        elif case == "pipeline":
            out = pipeline()
            print("OK pipeline rank", rank, out, flush=True)
        else:
            raise ValueError(case)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
