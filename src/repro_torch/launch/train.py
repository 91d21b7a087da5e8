"""Training launcher: the end-to-end fault-tolerant loop (the port's copy of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 50 --reduced --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        [--device cpu]

--reduced runs the smoke-scale config; without it the published widths.
It runs on the card unless ``--device cpu`` is given.  The loop wires
together: deterministic step-indexed data (exact resume), async atomic
checkpoints, NaN rollback, straggler detection, preemption checkpointing.
The reference's mesh and sharding rules are dropped on one card.  The
train step updates the model and optimizer state in place, so a rollback
restores the newest checkpoint over them (the reference discards the bad
step's new state instead).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, reduced_config
from ..data.pipeline import DataConfig, Prefetcher
from ..kernels import resolve_device, to_device
from ..models import ModelConfig
from ..train import checkpoint as ckpt
from ..train.fault import FaultConfig, Preemption, RunReport, StepTimer, is_bad
from ..train.optimizer import OptConfig
from ..train.train_step import TrainConfig, make_train_state, train_step


def _reset(params, opt_state, cfg: ModelConfig, device) -> None:
    """Write the initial state (``make_train_state``, seed 0) over
    ``params`` and ``opt_state``."""
    init_p, init_o = make_train_state(cfg, 0, device)
    with torch.no_grad():
        params.load_state_dict(init_p.state_dict())
        for part in ("mu", "nu"):
            for k, v in init_o[part].items():
                opt_state[part][k].copy_(v)
        opt_state["step"].copy_(init_o["step"])


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
               fcfg: FaultConfig, steps: int, ckpt_dir: str | None = None,
               preemption: Preemption | None = None,
               inject_nan_at: int | None = None,
               log_every: int = 10,
               device: str | torch.device | None = None,
               state: tuple | None = None) -> RunReport:
    """Train to ``steps``.  ``state`` is the (params, opt_state) to train in
    place; None makes it (``make_train_state``, seed 0) on ``device``."""
    report = RunReport()
    preemption = preemption or Preemption()
    dev = resolve_device(device)
    params, opt_state = state or make_train_state(cfg, 0, dev)
    start = 0
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            ckpt.restore(ckpt_dir, last, params, opt_state)
            start = last
            print(f"resumed from step {last}")

    timer = StepTimer(fcfg)
    pf = Prefetcher(dcfg, start)
    rollbacks = 0
    step = start
    pending_save = None
    try:
        while step < steps:
            s, host_batch = pf.next()
            if s != step:
                continue  # skip stale prefetches after rollback
            t0 = time.time()
            batch = {k: to_device(v, dev) for k, v in host_batch.items()}
            _, _, metrics = train_step(params, opt_state, batch, cfg, tcfg)
            metrics = {k: float(v) for k, v in metrics.items()}
            if inject_nan_at is not None and step == inject_nan_at:
                metrics["loss"] = float("nan")
                inject_nan_at = None
            if is_bad(metrics):
                # rollback: reload the last checkpoint, skip the bad batch
                rollbacks += 1
                report.rollbacks += 1
                if ckpt_dir is None or rollbacks > fcfg.max_rollbacks:
                    raise RuntimeError("unrecoverable divergence")
                if pending_save is not None:
                    pending_save.join()  # roll back to the newest checkpoint
                    pending_save = None
                last = ckpt.latest_step(ckpt_dir)
                if last is not None:
                    ckpt.restore(ckpt_dir, last, params, opt_state)
                else:
                    _reset(params, opt_state, cfg, dev)
                pf.close()
                step = (last or 0) + 1  # deterministic skip past the bad batch
                pf = Prefetcher(dcfg, step)
                print(f"rollback -> step {step}")
                continue
            dt = time.time() - t0
            report.history.append({"step": step, **metrics, "seconds": dt})
            if timer.record(step, dt):
                report.stragglers += 1
            step += 1
            report.steps_run += 1
            if step % log_every == 0 or step == steps:
                print(f"step {step:5d} loss={metrics['loss']:.4f} "
                      f"lr={metrics.get('lr', 0):.2e} {dt*1e3:.0f}ms",
                      flush=True)
            want_ckpt = ckpt_dir and (step % fcfg.checkpoint_every == 0
                                      or preemption.requested
                                      or step == steps)
            if want_ckpt:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save_async(ckpt_dir, step, params,
                                               opt_state)
                report.checkpoints += 1
                if preemption.requested:
                    break
    finally:
        if pending_save is not None:
            pending_save.join()
        pf.close()
    report.final_step = step
    return report


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainConfig(microbatches=args.microbatches,
                       opt=OptConfig(peak_lr=args.lr, warmup_steps=5,
                                     stable_steps=max(args.steps - 10, 5),
                                     decay_steps=5))
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size,
                      frames_dim=cfg.d_model if cfg.is_encdec else 0)
    fcfg = FaultConfig(checkpoint_every=max(args.steps // 4, 5))
    report = train_loop(cfg, tcfg, dcfg, fcfg, args.steps,
                        ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"done: {report}")


if __name__ == "__main__":
    main()
