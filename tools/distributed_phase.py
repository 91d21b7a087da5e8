#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s distributed phase alone on the card:

    python3 tools/distributed_phase.py

(a) a world of one (NCCL, a (1, 1) mesh): reduced qwen2 in float32 sharded
against unsharded within 1e-5, then full-width qwen2-1.5b in bf16 for a few
train steps through the sharded path (DTensor parameters, ZeRO state,
grad_pspecs) against the unsharded steps, ms a step both ways; (b) the
pipeline as two processes on the card; (c) the dry run's full-width cells,
computed in a process of its own started at the top.  Prints the card's
name and power limit and then the phase's JSON result as its last two
lines.  Exits non-zero without a card.
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
        sys.exit("distributed_phase: no CUDA device; this script runs on the "
                 "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        cells = pool.apply_async(cs.dryrun_cells)
        smi = cs.phase_device()
        t0 = time.perf_counter()
        res = cs.phase_distributed(dev, smi, cells)
        res["seconds"] = time.perf_counter() - t0
        cs.log(f"[distributed: {res['seconds']:.2f} s]")
    print(smi, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
