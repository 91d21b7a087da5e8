#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s aggregate phase alone on the card:

    python3 tools/agg_phase.py

Secure aggregation with the servers' share matrices and sums on the card:
agg_bench's three rows at full size, the model-update round (a 512 MiB
share matrix a server) and four processes over localhost TCP, every round
checked bit for bit.  No kernel of the port runs, so nothing is built.
Prints the card's name and power limit and then the phase's JSON result
as its last two lines.  Exits non-zero without a card.
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
        sys.exit("agg_phase: no CUDA device; this script runs on the card")
    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    t0 = time.perf_counter()
    res = cs.phase_aggregate(dev)
    res["aggregate_s"] = time.perf_counter() - t0
    print(smi, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
