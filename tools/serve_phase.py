#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s serve daemon phase alone on the card:

    python3 tools/serve_phase.py

Builds the kernels (the daemon's jobs launch the half gates and the NTT
kernels), starts ``python -m repro_torch serve`` as a process of its own
and drives it as the phase does: the plan-only cases cold and hot, the
executed jobs cold and hot, admission.  Then times each kernel at the
launch sizes of the daemon's paths (``serve daemon``: merge and rsum;
``aggsum``), as the record phases do.  Prints the card's name and power
limit and then the phase's JSON result as its last two lines.  Exits
non-zero without a card.
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
        sys.exit("serve_phase: no CUDA device; this script runs on the card")
    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    cs.phase_build()
    t0 = time.perf_counter()
    res, paths = cs.phase_serve_daemon(dev)
    res["serve_daemon_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, _ = cs.kernel_record(
        dev, {p: paths[p][0] for p in ("serve daemon", "aggsum")},
        {"garble_and": 0, "eval_and": 0})
    ntt_rows, _ = cs.ntt_record(dev, {"serve daemon": paths["serve daemon"][1]},
                                dict.fromkeys(cs.NTT_KERNELS, 0))
    res["record_s"] = time.perf_counter() - t0
    res["kernels"] = rows + ntt_rows
    print(smi, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
