"""``python -m repro_torch``: run a planned two-party job on the card.

    python -m repro_torch run --workload merge -n 16384 --budget 0.4 \\
        --prefetch 64 --lookahead 10000 --real --check [--device cpu]

``run`` traces, plans and executes in-process (trace → plan → execute)
and prints a JSON summary: timings, AND gates, swap traffic, outputs.
Only real two-party execution is ported; the plaintext oracle, saved
plans and the fleet launcher wait for later slices.
"""

from __future__ import annotations

import argparse
import json
import sys

from .api import JobSpec, Session


def _parse_budget(text: str) -> int | float:
    """``12`` → 12 frames; ``0.25`` → fraction of the working set."""
    if any(c in text for c in ".eE"):
        return float(text)
    return int(text)


def _run(args: argparse.Namespace) -> int:
    if not args.real:
        print("error: only real two-party execution is ported; pass --real",
              file=sys.stderr)
        return 2
    spec = JobSpec(args.workload, n=args.n, memory_budget=args.budget,
                   lookahead=args.lookahead, prefetch_pages=args.prefetch)
    s = Session(spec, device=args.device)
    out = s.execute(real=True, check=args.check)
    ands = s.gate_counts[0].ands
    summary = {
        "device": str(s.device),
        "spec": {"workload": s.spec.workload, "n": s.spec.n,
                 "memory_budget": s.spec.memory_budget,
                 "num_frames": s.config.num_frames if s.config else None,
                 "prefetch_pages": s.config.prefetch_pages if s.config
                 else None, "lookahead": s.spec.lookahead},
        "timings_s": s.timings,
        "and_gates": ands,
        "and_gates_per_s": ands / s.timings["execute_s"],
        "swap_ins": [e.swap_ins for e in s.engine_stats],
        "swap_outs": [e.swap_outs for e in s.engine_stats],
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
    r.add_argument("--workload", default="merge")
    r.add_argument("-n", type=int, default=None,
                   help="records per party (default: the workload's)")
    r.add_argument("--budget", type=_parse_budget, required=True,
                   help="frames (int) or working-set fraction (float)")
    r.add_argument("--prefetch", type=int, default=0)
    r.add_argument("--lookahead", type=int, default=10_000)
    r.add_argument("--real", action="store_true",
                   help="real two-party garbled circuits (the only mode)")
    r.add_argument("--check", action="store_true",
                   help="compare outputs with the workload's oracle")
    r.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")
    r.add_argument("--json", default=None, help="also write the summary here")
    args = ap.parse_args(argv)
    return _run(args)


if __name__ == "__main__":
    sys.exit(main())
