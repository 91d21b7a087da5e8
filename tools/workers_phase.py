#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s build and workers phases alone on the card:

    python3 tools/workers_phase.py

Builds the CUDA libraries, then runs the multi-worker jobs of the workers
phase (four workers a party, batched and overlap loops, each checked
against its oracle) and its card-against-CPU parity, and prints the
card's name and power limit and then the phase's JSON result as its last
two lines.  Exits non-zero without a card.
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
        sys.exit("workers_phase: no CUDA device; this script runs on the card")
    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    cs.phase_build()
    t0 = time.perf_counter()
    res, gc, ntt = cs.phase_workers(dev)
    res["phase_s"] = time.perf_counter() - t0
    res["garble_sizes"] = dict(sorted(gc["launch_sizes"]["garble"].items()))
    print(smi, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
