#!/usr/bin/env python3
"""GC jobs whose ops make many small AND calls, run in turns from this
checkout and another one, on one card.

    python3 tools/gc_turns.py --other DIR [--rounds 10] [--job binfclayer:512]

DIR is another checkout of the repository (an earlier commit unpacked with
``git archive``).  Each round runs two processes in the order other, this
(odd rounds) or this, other (even rounds), each from its checkout's root
with that checkout's package and half-gates kernels (built once per
checkout, then reused): each ``--job`` (workload:n, default binfclayer
n=512) unbounded, two-party on the batched loop, checked against the
oracle, once as a warm-up and once timed.  It prints one JSON line per run
(execute s and AND gates of each job) and the medians of each side; two
versions compare only inside one call, in turns, because the host's pace
moves between calls.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: run in a checkout's root with the jobs as argv: prints "RESULT {...}"
RUN = r"""
import json, sys, torch
sys.path.insert(0, "src")
from repro_torch.api import JobSpec, Session
dev = torch.device("cuda", 0)
out = {}
for job in sys.argv[1:]:
    wl, n = job.split(":")
    for _ in range(2):
        s = Session(JobSpec(wl, n=int(n), plan_mode="unbounded"), device=dev)
        s.execute(real=True, check=True)
    out[job + " execute_s"] = s.timings["execute_s"]
    out[job + " ands"] = s.gate_counts[0].ands
print("RESULT " + json.dumps(out), flush=True)
"""


def run(root: str, jobs: list[str]) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, *jobs], cwd=root,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"run in {root} failed ({proc.returncode}):\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    return json.loads(line.split("RESULT ", 1)[1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--job", action="append",
                    help="workload:n, unbounded (default binfclayer:512)")
    args = ap.parse_args()
    jobs = args.job or ["binfclayer:512"]
    other = os.path.abspath(args.other)
    if not os.path.isdir(os.path.join(other, "src", "repro_torch")):
        sys.exit(f"{other} holds no src/repro_torch")
    sides = {"other": other, "this": HERE}
    runs = {"other": [], "this": []}
    for rnd in range(args.rounds):
        order = ("other", "this") if rnd % 2 == 0 else ("this", "other")
        for side in order:
            got = run(sides[side], jobs)
            runs[side].append(got)
            print(json.dumps({"round": rnd, "side": side, **got}),
                  flush=True)
    medians = {side: {k: statistics.median(r[k] for r in rs)
                      for k in rs[0]} for side, rs in runs.items()}
    print(json.dumps({"medians": medians}), flush=True)
    os.system("nvidia-smi --query-gpu=name,power.limit "
              "--format=csv,noheader")


if __name__ == "__main__":
    main()
