"""Multi-pod dry run: build every (architecture x input shape) step on the
production meshes and record memory, FLOPs, collectives and the roofline:
the port's copy of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape decode_32k [--multi-pod] [--seq-shard]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

One cell starts a fake process group of the mesh's world size in this
process (``torch.testing._internal.distributed.fake_pg``: collectives
complete at once and move nothing) and builds parameters, optimizer state,
the batch and the caches as DTensors of fake tensors (no storage) in the
specs of ``launch.specs`` and ``distributed.sharding``.  Then it runs the
step once as rank 0 (train: ``train_step`` with the ZeRO specs; prefill;
decode through ``serve_step`` / ``serve_step_encdec``) under a
``launch.analysis.StepCounter``.  It needs no card.

Artifacts land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``--out`` names another directory) under the reference's keys.  What
stands behind each:

* ``lower_s``: seconds to build the fake DTensor parameters, state and
  inputs; ``compile_s``: seconds to run the step on them (there is no
  compiler: it is the step's trace);
* ``memory``: ``argument_bytes`` the local shards of every input,
  ``output_bytes`` those of the outputs, ``temp_bytes`` the peak of the
  bytes held by tensors the step made (``StepCounter.peak_bytes``);
* ``collectives``: rank 0's collectives' result bytes by kind;
* ``roofline``: ``analysis.analytic_roofline`` with H100 constants;
  ``roofline_hlo_raw``: the counted terms (FLOPs, bytes accessed op by
  op, collective bytes) over the same constants.

The seconds of a roofline are model outputs, not device times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import signal
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, all_cells, get_config, reduced_config
from ..distributed.sharding import (NamedSharding, P, distribute,
                                    distribute_opt_state, distribute_params,
                                    params_pspecs, rules_for, use_rules,
                                    zero_pspecs)
from ..models import ModelConfig, encdec_init_caches, encdec_prefill
from ..models import lm_prefill
from ..models.lm import set_remat_policy
from ..serve.serve_step import serve_step, serve_step_encdec
from ..train.train_step import TrainConfig, train_step
from . import specs as S
from .analysis import (Roofline, StepCounter, analytic_roofline,
                       collective_bytes, model_flops)
from .mesh import H100, PRODUCTION_SHAPES, make_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _dp_size(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.mesh_dim_names:
            n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _fake(mode: FakeTensorMode, shape, dtype) -> torch.Tensor:
    with mode:
        return torch.zeros(shape, dtype=dtype)


def build_step(cfg: ModelConfig, cell, mesh, rules, mode: FakeTensorMode,
               microbatches=None):
    """Returns (fn, args): the step and its fake DTensor arguments."""
    params = S.params_struct(cfg, mode)
    if cell.kind == "train":
        params.requires_grad_(True)
    pspecs = params_pspecs(params, rules)
    with mode:
        distribute_params(params, S.named(pspecs, mesh))
    batch_shapes, batch_pspecs, shardable = S.batch_specs(
        cfg, cell, rules, _dp_size(mesh))
    batch = {k: distribute(_fake(mode, v.shape, v.dtype),
                           NamedSharding(mesh, batch_pspecs[k]))
             for k, v in batch_shapes.items()}
    bspec = rules.axis("batch") if shardable else None

    if cell.kind == "train":
        # ZeRO-1: moments shard over the data axes on top of TP
        zero_specs = zero_pspecs(params, rules, mesh)
        with mode:
            opt = distribute_opt_state(S.opt_struct(params, mode),
                                       S.named(zero_specs, mesh))
        dp = _dp_size(mesh)
        mb = microbatches or max(1, min(16, cell.global_batch // dp))
        tcfg = TrainConfig(microbatches=mb)

        def fn(params, opt_state, batch):
            with use_rules(rules):
                return train_step(params, opt_state, batch, cfg, tcfg,
                                  grad_pspecs=zero_specs)
        return fn, (params, opt, batch)

    if cell.kind == "prefill":
        if cfg.is_encdec:
            def fn(params, batch):
                with use_rules(rules), torch.no_grad():
                    return encdec_prefill(params, batch["frames"],
                                          batch["tokens"], cfg)
            return fn, (params, batch)

        def fn(params, batch):
            with use_rules(rules), torch.no_grad():
                logits, caches = lm_prefill(params, batch["tokens"], cfg,
                                            max_seq=cell.seq_len)
                return logits
        return fn, (params, batch)

    # decode: one new token against a seq_len cache
    b = cell.global_batch
    token = distribute(_fake(mode, (b, 1), torch.int32),
                       NamedSharding(mesh, P(bspec, None)))
    clen = distribute(_fake(mode, (b,), torch.int32),
                      NamedSharding(mesh, P(bspec)))
    if cfg.is_encdec:
        with mode:
            caches = encdec_init_caches(cfg, b, cell.seq_len, "cpu")
        kv = rules.axis("kv_heads")
        caches = tuple(distribute(c, NamedSharding(
            mesh, P(None, bspec, None, kv, None))) for c in caches)
        memory = distribute(_fake(mode, (b, 1024, cfg.d_model),
                                  getattr(torch, cfg.dtype)),
                            NamedSharding(mesh, P(bspec, None, None)))

        def fn(params, token, memory, caches, cache_len):
            with use_rules(rules), torch.no_grad():
                nxt, caches, _ = serve_step_encdec(params, token, memory,
                                                   caches, cache_len, cfg)
                return nxt, caches
        return fn, (params, token, memory, caches, clen)

    caches = S.distribute_tree(S.cache_struct(cfg, b, cell.seq_len, mode),
                               S.cache_pspecs(cfg, rules, shardable), mesh)

    def fn(params, token, caches, cache_len):
        with use_rules(rules), torch.no_grad():
            nxt, caches, _ = serve_step(params, token, caches, cache_len,
                                        cfg)
            return nxt, caches
    return fn, (params, token, caches, clen)


def _params_as_lists(tree):
    """``tree`` with each model replaced by the list of its parameters."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, (list, tuple)):
        return [_params_as_lists(t) for t in tree]
    return tree


def _local_bytes(tree) -> int:
    """The bytes of this rank's shards of every tensor in ``tree`` (a
    model's parameters, nested containers)."""
    total = 0
    for t in tree_leaves(_params_as_lists(tree)):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


def _timed_out(signum, frame):
    raise TimeoutError("the cell ran past its time limit")


def run_cell(arch: str, shape: str, multi_pod: bool, seq_shard: bool = False,
             save: bool = True, microbatches=None, dp_over_model: bool = False,
             grad_compression: str | None = None,
             kv_dtype: str | None = None, variant: str = "",
             remat_policy: str = "full", mesh_shape=None,
             reduced: bool = False, seq_len: int | None = None,
             global_batch: int | None = None,
             timeout_s: float | None = None, out_dir: str = OUT_DIR) -> dict:
    """One cell.  ``mesh_shape`` (with the production mesh's last axes),
    ``reduced`` (``configs.reduced_config``), ``seq_len`` and
    ``global_batch`` size it down for tests and a card's smoke run.  A cell
    still running after ``timeout_s`` seconds fails with a TimeoutError
    (the main thread only: it uses SIGALRM)."""
    set_remat_policy(remat_policy)
    cfg = (reduced_config if reduced else get_config)(arch)
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    cell = dataclasses.replace(
        SHAPES[shape], seq_len=seq_len or SHAPES[shape].seq_len,
        global_batch=global_batch or SHAPES[shape].global_batch)
    prod_shape, axes = PRODUCTION_SHAPES[multi_pod]
    mshape = tuple(mesh_shape or prod_shape)
    axes = axes[len(axes) - len(mshape):]
    world = 1
    for v in mshape:
        world *= v
    mesh_name = ("pod512" if multi_pod else "pod256") if mesh_shape is None \
        else "x".join(map(str, mshape))
    result = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "mesh_shape": dict(zip(axes, mshape)), "ok": False,
              "seq_shard": seq_shard, "variant": variant,
              "reduced": reduced, "seq_len": cell.seq_len,
              "global_batch": cell.global_batch,
              "hardware": dataclasses.asdict(H100)}
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    if timeout_s:
        signal.signal(signal.SIGALRM, _timed_out)
        signal.setitimer(signal.ITIMER_REAL, timeout_s)
    try:
        mesh = make_mesh(mshape, axes, "cpu")
        rules = rules_for(cfg, mesh, seq_sharding=seq_shard,
                          dp_over_model=dp_over_model)
        rules.grad_compression = grad_compression
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        t0 = time.time()
        fn, args = build_step(cfg, cell, mesh, rules, mode,
                              microbatches=microbatches)
        arg_bytes = _local_bytes(args)
        t1 = time.time()
        counter = StepCounter()
        counter.hold(_params_as_lists(args))
        with mode, counter:
            out = fn(*args)
        t2 = time.time()
        out_bytes = _local_bytes(out) if cell.kind != "train" else \
            _local_bytes(out[2])
        del out
        coll = collective_bytes(counter.records)
        dp = _dp_size(mesh)
        mb = microbatches or max(1, min(16, cell.global_batch // dp))
        hlo_roof = Roofline(
            flops=float(counter.flops),
            hbm_bytes=float(counter.bytes_accessed),
            coll_bytes=float(sum(v for k, v in coll.items()
                                 if k != "count")),
            model_flops_per_chip=model_flops(cfg, cell, world))
        roof = analytic_roofline(cfg, cell, mesh, rules, microbatches=mb,
                                 remat_policy=remat_policy)
        result.update({
            "ok": True,
            "lower_s": t1 - t0, "compile_s": t2 - t1,
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "temp_bytes": counter.peak_bytes,
                       "code_bytes": 0},
            "collectives": coll,
            "roofline": roof,
            "roofline_hlo_raw": hlo_roof.as_dict(),
        })
    except Exception as e:  # noqa: BLE001 -- failures are the experiment
        result["error"] = f"{type(e).__name__}: {e}"[:4000]
        result["traceback"] = traceback.format_exc()[-2000:]
    finally:
        if timeout_s:
            signal.setitimer(signal.ITIMER_REAL, 0)
        dist.destroy_process_group()
    if save:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape}__{mesh_name}"
        if seq_shard:
            fname += "__sp"
        if variant:
            fname += f"__{variant}"
        with open(os.path.join(out_dir, fname + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="an arch, or several joined by commas")
    ap.add_argument("--shape", help="a shape cell, or several joined by "
                                    "commas")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--dp-over-model", action="store_true")
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--remat-policy", default="full")
    ap.add_argument("--variant", default="")
    ap.add_argument("--mesh", default=None,
                    help="a smaller mesh, e.g. 2,2 (the production axes' "
                         "last ones)")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells at once, a process each")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="seconds a cell may take before it is recorded "
                         "as failed")
    ap.add_argument("--out", default=OUT_DIR,
                    help="the artifacts' directory")
    args = ap.parse_args(argv)

    mesh_shape = tuple(int(v) for v in args.mesh.split(",")) \
        if args.mesh else None
    archs = args.arch.split(",") if args.arch else None
    shapes = args.shape.split(",") if args.shape else None
    # --all: every cell, or those of the archs / shapes named
    cells = [(a, s) for a, s in all_cells()
             if (archs is None or a in archs)
             and (shapes is None or s in shapes)] if args.all else [
        (a, s) for a in archs for s in shapes]
    kws = [dict(arch=arch, shape=shape, multi_pod=args.multi_pod,
                seq_shard=args.seq_shard, microbatches=args.microbatches,
                dp_over_model=args.dp_over_model,
                grad_compression=args.grad_compression,
                kv_dtype=args.kv_dtype, remat_policy=args.remat_policy,
                variant=args.variant, mesh_shape=mesh_shape,
                reduced=args.reduced, seq_len=args.seq_len,
                global_batch=args.global_batch,
                timeout_s=args.cell_timeout, out_dir=args.out)
           for arch, shape in cells]
    if args.jobs > 1:
        pool = multiprocessing.get_context("spawn").Pool(
            args.jobs, maxtasksperchild=1)
        results = pool.imap_unordered(_run_cell_kw, kws)
    else:
        pool, results = None, map(_run_cell_kw, kws)
    failures = 0
    for r in results:
        arch, shape = r["arch"], r["shape"]
        if r["ok"]:
            roof = r["roofline"]
            mem = r["memory"]
            print(f"[OK ] {arch:24s} {shape:12s} {r['mesh']} "
                  f"build={r['lower_s']:6.1f}s trace={r['compile_s']:6.1f}s "
                  f"dom={roof['dominant']:10s} "
                  f"roofline={roof['roofline_fraction']:.3f} "
                  f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
                  f"temp={mem['temp_bytes'] / 2**30:.2f}GiB", flush=True)
        else:
            failures += 1
            print(f"[FAIL] {arch:24s} {shape:12s}: "
                  f"{r['error'].splitlines()[0][:300]}", flush=True)
    if pool is not None:
        pool.close()
        pool.join()
    return 1 if failures else 0


def _run_cell_kw(kw: dict) -> dict:
    return run_cell(**kw)


if __name__ == "__main__":
    raise SystemExit(main())
