#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s shamir and bench phases alone on the card:

    python3 tools/shamir_phase.py

The shamir phase runs the n-party Shamir jobs on the scalar, batched and
overlap loops (each checked against its oracle, every rank's final engine
memory against the same jobs on the CPU, run in a process of their own)
and fig_nparty's predicted and measured NET stalls; the bench phase runs
``run_bench`` over the Fig. 8 cases and the simulator checks in a process
of its own meanwhile (host work).  Neither path launches a kernel, so
nothing is built.  Prints the card's name and power limit and then the
phases' JSON result as its last two lines.  Exits non-zero without a card.
"""

import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("shamir_phase: no CUDA device; this script runs on the card")
    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    with multiprocessing.get_context("spawn").Pool(1) as bench_pool:
        bench = bench_pool.apply_async(cs.bench_case)
        t0 = time.perf_counter()
        res = {"shamir": cs.phase_shamir(dev)}
        res["shamir_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["bench"] = cs.phase_bench(bench, None)
        res["bench_wait_s"] = time.perf_counter() - t0
    res["bench"].pop("rows")
    print(smi, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
