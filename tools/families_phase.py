#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s serving phases of every model family alone on
the card:

    python3 tools/families_phase.py

Builds the paged-attention library, holds the kernel against its plain
version (the attn kernels phase, with the families' head shapes), runs
the families parity phase (each family's reduced config, card against
CPU) and the serve families phase (deepseek-moe-16b, zamba2-7b,
xlstm-1.3b and seamless-m4t-medium at their published widths, qwen2-1.5b
with the int8 KV cache and with a prompt of 8192 tokens), then times the
kernel at each paged path's lengths and heads.  Prints the card's name and
power limit and then the phases' JSON result as its last two lines.
Exits non-zero without a card.
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
        sys.exit("families_phase: no CUDA device; this script runs on the "
                 "card")
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

    timed("build", cs.pk.library)
    res["attn_err"] = timed("attn kernels", cs.phase_attn_kernels, dev)
    res["families_parity"] = timed("families parity",
                                   cs.phase_families_parity, dev)
    qwen2 = cs.init_lm(cs.QWEN2, 0, dev)
    res["serve_families"], paths = timed("serve families",
                                         cs.phase_serve_families, dev, qwen2)
    res["by_path"] = timed("attn by path", cs._attn_by_path, dev, paths)
    res["seconds"] = seconds
    print(smi, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
