"""``python -m repro_torch``: run a job on the card.

    python -m repro_torch run --workload merge -n 16384 --budget 0.4 \\
        --prefetch 64 --lookahead 10000 --real --check [--device cpu]
    python -m repro_torch run --workload ljoin -n 256 --budget 0.4 \\
        --prefetch 64 --check [--device cpu]
    python -m repro_torch run --workload rmvmul -n 24 --budget 0.4 \\
        --prefetch 8 --ckks-ring 1024 --check [--device cpu]
    python -m repro_torch run --workload merge -n 32 --mode unbounded \\
        --real --check [--device cpu]
    python -m repro_torch run --workload merge -n 32 --budget 6 \\
        --prefetch 1 --policy lru --swap-bypass --exec-backend scalar \\
        --storage memmap --real --check [--device cpu]
    python -m repro_torch run --workload merge -n 256 --workers 4 \\
        --budget 0.4 --prefetch 16 --exec-backend overlap --real --check \\
        [--parallel thread] [--device cpu]

``run`` traces, plans and executes in-process (trace → plan → execute)
and prints a JSON summary: timings, swap traffic, the engine's frame
bytes, outputs, and for a garbled-circuit job run with ``--real`` its AND
gates, for a CKKS job its instructions, homomorphic ops per second and
transforms.  The
knobs are the JAX package's: ``--mode`` (memory, or unbounded: the
traced program over the whole virtual address space, no budget; the
default is unbounded without ``--budget``), ``--policy``,
``--swap-bypass``, ``--exec-backend`` (batched by default, scalar, or
overlap), ``--storage`` (ram: pinned host pages, or memmap: a swap file),
``--workers`` (engines per party, which exchange values over NET_*
directives) and ``--parallel`` (how the workers' programs are planned:
serial, thread or process).  Garbled circuits run with real two-party
crypto with ``--real``, and otherwise in the clear through the plaintext
oracle driver; CKKS is real crypto either way.  The summary gives each
engine's swaps and NET traffic, and the transport's traffic per link
(worker links and party links, by global rank).  The streaming planner,
saved plans and the fleet launcher wait for later slices.
"""

from __future__ import annotations

import argparse
import json
import sys

from .api import JobSpec, Session
from .core.transport import aggregate_links
from .protocols.ckks.driver import homomorphic_ops
from .workloads import all_names


def _parse_budget(text: str) -> int | float:
    """``12`` → 12 frames; ``0.25`` → fraction of the working set."""
    if any(c in text for c in ".eE"):
        return float(text)
    return int(text)


def _protocol_summary(s: Session, real: bool) -> dict:
    t = s.timings["execute_s"]
    if s.protocol == "ckks":
        he = homomorphic_ops(s.op_counts)
        p = s.ckks_params()
        return {"ckks": {"n_ring": p.n_ring, "levels": p.levels},
                "instructions": [e.instructions for e in s.engine_stats],
                "op_counts": s.op_counts,
                "homomorphic_ops": he, "homomorphic_ops_per_s": he / t,
                "transforms": {k: s.ckks_counts.get(k, 0)
                               for k in ("ntt_forward", "ntt_inverse")},
                "mul_mod_rows": s.ckks_counts.get("mul_mod", 0)}
    if not real:
        return {"driver": "gc-plaintext",
                "instructions": [e.instructions for e in s.engine_stats]}
    ands = s.gate_counts[0].ands
    return {"driver": "gc-2party", "and_gates": ands,
            "and_gates_per_s": ands / t}


def _run(args: argparse.Namespace) -> int:
    mode = args.mode or ("memory" if args.budget is not None
                         else "unbounded")
    try:
        spec = JobSpec(args.workload, n=args.n, num_workers=args.workers,
                       parallel_plan=args.parallel,
                       memory_budget=args.budget,
                       lookahead=args.lookahead, prefetch_pages=args.prefetch,
                       policy=args.policy, swap_bypass=args.swap_bypass,
                       plan_mode=mode, exec_backend=args.exec_backend,
                       storage=args.storage, ckks_ring=args.ckks_ring,
                       ckks_levels=args.ckks_levels)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    s = Session(spec, device=args.device)
    out = s.execute(real=args.real, check=args.check)
    summary = {
        "device": str(s.device),
        "spec": {"workload": s.spec.workload, "n": s.spec.n,
                 "plan_mode": s.spec.plan_mode,
                 "memory_budget": s.spec.memory_budget,
                 "num_frames": s.config.num_frames if s.config else None,
                 "prefetch_pages": s.config.prefetch_pages if s.config
                 else None, "lookahead": s.spec.lookahead,
                 "policy": s.spec.policy, "swap_bypass": s.spec.swap_bypass,
                 "exec_backend": s.spec.exec_backend,
                 "storage": s.spec.storage,
                 "num_workers": s.spec.num_workers,
                 "parallel_plan": s.spec.parallel_plan},
        "timings_s": s.timings,
        **_protocol_summary(s, args.real),
        "swap_ins": [e.swap_ins for e in s.engine_stats],
        "swap_outs": [e.swap_outs for e in s.engine_stats],
        "frame_bytes": [e.frame_bytes for e in s.engine_stats],
        "net_messages": [e.net_messages for e in s.engine_stats],
        "posted_recvs": [e.posted_recvs for e in s.engine_stats],
        "max_inflight_recvs": [e.max_inflight_recvs
                               for e in s.engine_stats],
        "links": {f"{src}->{dst}": [t.messages, t.bytes] for (src, dst), t
                  in sorted(aggregate_links(s.transport_stats).items())},
        "outputs": len(out),
        "checked": bool(args.check),
    }
    text = json.dumps(summary, indent=2)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="trace, plan and execute a job")
    r.add_argument("--workload", default="merge", choices=all_names())
    r.add_argument("-n", type=int, default=None,
                   help="records per party (default: the workload's)")
    r.add_argument("--budget", type=_parse_budget, default=None,
                   help="frames (int) or working-set fraction (float); "
                   "omit for unbounded")
    r.add_argument("--prefetch", type=int, default=0)
    r.add_argument("--lookahead", type=int, default=10_000)
    r.add_argument("--mode", default=None, choices=("memory", "unbounded"),
                   help="plan mode (default: memory with --budget, "
                   "unbounded without)")
    r.add_argument("--policy", default="min",
                   choices=("min", "min_clean", "lru", "fifo"),
                   help="eviction policy")
    r.add_argument("--swap-bypass", action="store_true",
                   help="serve a read from its page's pending write")
    r.add_argument("--exec-backend", dest="exec_backend", default="batched",
                   choices=("scalar", "batched", "overlap"),
                   help="engine loop: a batch schedule, one instruction at "
                   "a time, or an overlap schedule (NET sends hoisted, "
                   "receives completed where needed); outputs are "
                   "identical")
    r.add_argument("--workers", type=int, default=1,
                   help="engines per party (NET_* directives between them)")
    r.add_argument("--parallel", default="serial",
                   choices=("serial", "thread", "process"),
                   help="how the workers' programs are planned")
    r.add_argument("--storage", default="ram", choices=("ram", "memmap"),
                   help="swap storage: pinned host pages or a swap file")
    r.add_argument("--real", action="store_true",
                   help="real two-party garbled circuits (default: the "
                   "plaintext oracle; CKKS needs no flag)")
    r.add_argument("--ckks-ring", type=int, default=None,
                   help="CKKS ring dimension N (default: the workload's)")
    r.add_argument("--ckks-levels", type=int, default=None,
                   help="CKKS multiplicative depth (default: the workload's)")
    r.add_argument("--check", action="store_true",
                   help="compare outputs with the workload's oracle")
    r.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")
    r.add_argument("--json", default=None, help="also write the summary here")
    args = ap.parse_args(argv)
    return _run(args)


if __name__ == "__main__":
    sys.exit(main())
