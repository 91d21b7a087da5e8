#!/usr/bin/env python3
"""The CKKS main job and the NTT kernels' record, run in turns from this
checkout and another one, on one card.

    python3 tools/ckks_turns.py --other DIR [--rounds 3]

DIR is another checkout of the repository (an earlier commit unpacked with
``git archive``).  Each round runs four processes, other, this, this,
other, each from its checkout's root with that checkout's ``chip_smoke.py``
and kernels (built once per checkout, then reused): the CKKS parity phase
(a warm-up, as in the whole script), the CKKS main job (rmvmul n=24, ring
1024, checked against the oracle), and the NTT record (device time per
launch over the main job's launch sizes and at 4096 rows, profiler; and,
where the checkout has the fused kernel, the three launches each fused
one replaces, timed at the same sizes), with the launches of each kind.
It prints one JSON line per run and the medians of each side; two
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

#: run in a checkout's root: prints "RESULT {...}" as its last line
RUN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev = torch.device("cuda", 0)
cs.phase_build()
cs.phase_ckks_parity(dev)
counts, m = cs.phase_ckks_main(dev)
import inspect
paths = {"ckks main": counts} \
    if "paths" in inspect.signature(cs.ntt_record).parameters else counts
rows, big = cs.ntt_record(dev, paths, {k: 0 for k in cs.NTT_KERNELS})
out = {"execute_s": m["execute_s"], "he_ops_per_s": m["he_ops_per_s"]}
for r in rows:
    out[r["name"] + "_ms"] = r["ms"]
    out[r["name"] + "_4096_ms"] = big[r["name"]]["ms"]
for kind, k in counts["launches"].items():
    out[kind + "_launches"] = k
if "ntt_mul_main" in big:
    out["replaced_ms"] = big["ntt_mul_main"]["unfused_ms"]
print("RESULT " + json.dumps(out), flush=True)
"""


def run(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root,
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
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    if not os.path.exists(os.path.join(other, "chip_smoke.py")):
        sys.exit(f"{other} holds no chip_smoke.py")
    sides = {"other": other, "this": HERE}
    runs = {"other": [], "this": []}
    for rnd in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            got = run(sides[side])
            runs[side].append(got)
            print(json.dumps({"round": rnd, "side": side, **got}),
                  flush=True)
    medians = {side: {k: statistics.median(r[k] for r in rs)
                      for k in rs[0]} for side, rs in runs.items()}
    print(json.dumps({"medians": medians}), flush=True)


if __name__ == "__main__":
    main()
