#!/usr/bin/env python3
"""The serve main job alone and after the baselines phase's runs, in
turns, on one card.

    python3 tools/serve_turns.py [--rounds 2]

Each round runs four processes from this checkout's root: alone, after,
after, alone.  "alone" builds the kernels and runs ``chip_smoke.py``'s
serve main phase (qwen2-1.5b at full width, paged decode held against the
contiguous one); "after" first runs what the baselines phase runs (the GC
main job unbounded, the CKKS main job in turns, every policy, the scalar
loop, the swap file, the parity jobs and the profile), then the same
serve main phase.  It prints one JSON line per run (ms per decode step,
paged and contiguous, and the medians of the phase's own decode turns)
and the medians of each side: whether the earlier work in a process
slows the serving path, apart from the host's pace between calls.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: run in the checkout's root: prints "RESULT {...}" as its last line
RUN = r"""
import json, statistics, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev = torch.device("cuda", 0)
cs.phase_build()
if sys.argv[1] == "after":
    cs._gc_checked_run(cs.MAIN_UNBOUNDED, dev)
    _, ckks_planned = cs._baseline_ckks_turns(dev)
    _, gc_min = cs._baseline_policies(dev)
    cs._baseline_scalar(dev, gc_min, ckks_planned)
    cs._baseline_memmap(dev, gc_min, ckks_planned)
    del gc_min, ckks_planned
    cs._baseline_parity(dev)
    cs._baseline_profile(dev)
_, m, _ = cs.phase_serve_main(dev)
t = m["decode_turns_ms"]
print("RESULT " + json.dumps({
    "ms_per_decode_step": m["ms_per_decode_step"],
    "contiguous_ms_per_decode_step": m["contiguous_ms_per_decode_step"],
    "turns_paged_median": statistics.median(t["paged"]),
    "turns_contiguous_median": statistics.median(t["contiguous"])}),
    flush=True)
"""


def run(side: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, side], cwd=HERE,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"run {side} failed ({proc.returncode}):\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    return json.loads(line.split("RESULT ", 1)[1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    runs = {"alone": [], "after": []}
    for rnd in range(args.rounds):
        for side in ("alone", "after", "after", "alone"):
            got = run(side)
            runs[side].append(got)
            print(json.dumps({"round": rnd, "side": side, **got}),
                  flush=True)
    medians = {side: {k: statistics.median(r[k] for r in rs)
                      for k in rs[0]} for side, rs in runs.items()}
    print(json.dumps({"medians": medians}), flush=True)


if __name__ == "__main__":
    main()
