#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training phases alone on the card:

    python3 tools/train_phase.py

The train parity phase (each family's reduced config, one train step on
the card against the CPU), the train phase (qwen2-1.5b at its published
widths in bf16: 8 steps of the port's train_loop, one step timed in
halves, one under torch.profiler and one more with the host's ops, for
the device time of each ATen op; then the reduced loop with
checkpoints: resume and a NaN rollback) and the offload phase (fx_trace of
the full-width gradient, plan_offload, the pinned copy rate, the real
gradient's allocator peak).  Prints the card's name and power limit and
then the phases' JSON result as its last two lines.  Exits non-zero
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
        sys.exit("train_phase: no CUDA device; this script runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    res, seconds = {}, {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        cs.log(f"[{name}: {seconds[name]:.2f} s]")
        return out

    res["train_parity"] = timed("train parity", cs.phase_train_parity, dev)
    res["train"] = timed("train", cs.phase_train, dev, smi, True)
    model = cs.init_lm(cs.QWEN2, 0, dev)
    res["offload"] = timed("offload", cs.phase_offload, dev, model)
    res["seconds"] = seconds
    print(smi, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
