#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s build and fleet phases alone on the card:

    python3 tools/fleet_phase.py

Builds the CUDA libraries, runs in this process what the fleet phase
holds its jobs to (the parity phase's planned merge n=256 with its table
digest, and the unbounded merge n=2048 at four workers a party and one
and rsum n=256 at four workers, ring 1024, as the workers phase runs
them),
then the fleet phase: each job saved with ``plan`` and run with
``fabric``, one process a rank.  Prints the card's name and power limit
and then the phase's JSON result as its last two lines.  Exits non-zero
without a card.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("fleet_phase: no CUDA device; this script runs on the card")
    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    cs.phase_build()
    t0 = time.perf_counter()
    s, parity_out, _ = cs._run(cs.PARITY, dev, digest=True)
    parity_ref = {"outputs": parity_out,
                  "ands": [g.ands for g in s.gate_counts],
                  "digest": s.table_digest}
    jobs = {cs._worker_key(wl, n, plan, p, "batched"):
            cs._worker_job(wl, n, plan, p, "batched", dev)
            for wl, n, plan, p in (
                ("merge", cs.FIG10_N, cs.UNBOUNDED, cs.WORKERS),
                ("merge", cs.FIG10_N, cs.UNBOUNDED, 1),
                ("rsum", 256, cs.W_CKKS_PLAN, cs.WORKERS))}
    in_process_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, gc, ntt = cs.phase_fleet(dev, parity_ref, {"jobs": jobs})
    res["phase_s"] = time.perf_counter() - t0
    res["in_process_s"] = in_process_s
    res["garble_sizes"] = dict(sorted(gc["launch_sizes"]["garble"].items()))
    print(smi, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
