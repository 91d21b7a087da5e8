#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s build and streaming phases alone on the card:

    python3 tools/streaming_phase.py

Builds the CUDA libraries and starts Fig. 8's streaming case (merge
n=131072 planned out of core, host work only) in a process of its own;
runs in this process what the streaming phase holds its jobs to: the
parity phase (the planned merge n=256 and the sync-swap job, card
against CPU), the CKKS main job (and rstats), ljoin n=128 at budget 0.4
with 64 prefetch pages planned in memory, and GC main's in-memory plan
(planned, not run: its records digest is what the main phase would
run); then the streaming phase.  Prints the card's name and power limit
and then the phase's JSON result as its last two lines.  Exits non-zero
without a card.
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
        sys.exit("streaming_phase: no CUDA device; this script runs on the "
                 "card")
    dev = torch.device("cuda", 0)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(1) as case_pool, ctx.Pool(1) as pool:
        case = case_pool.apply_async(cs.streaming_case)
        cpu = pool.apply_async(cs.parity_cpu)
        smi = cs.phase_device()
        cs.phase_build()
        t0 = time.perf_counter()
        _, parity_ref = cs.phase_parity(dev, cpu.get())
        ckks_counts, _, ckks_out = cs.phase_ckks_main(dev)
        wl, n, plan = cs.STREAM_LJOIN
        s, _, _ = cs._gc_job(wl, n, plan, dev)
        st = s.engine_stats[0]
        gc_ref = {f"{wl}-{n}-memory": {
            "ands": s.gate_counts[0].ands,
            "swaps": [st.swap_ins, st.swap_outs],
            "execute_s": s.timings["execute_s"]}}
        main_digest = cs.program_digest(cs.Session(
            cs.JobSpec("merge", **cs.MAIN), device=dev).plan()[0])
        refs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res, gc, ntt = cs.phase_streaming(dev, parity_ref,
                                          (ckks_counts, ckks_out), gc_ref,
                                          main_digest, case)
    res["phase_s"] = time.perf_counter() - t0
    res["refs_s"] = refs_s
    res["garble_sizes"] = dict(sorted(gc["launch_sizes"]["garble"].items()))
    print(smi, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
