#!/usr/bin/env python3
"""Where the fused product should stop giving each stack a cluster of CTAs
(one a row) and give it one CTA (its rows one after another): the fused
launch shapes of the CKKS main and rstats jobs, and a sweep of the tensor
product's and of one product's shape over the number of stacks, each
timed both ways on one card.

    python3 tools/ntt_mul_spread.py [--json FILE]

Runs the two jobs as ``chip_smoke.py`` runs them (checked against their
oracles) to collect their launch shapes, then times every shape with
``ops.MUL_SPREAD_LIMIT`` set so that each stack takes a cluster, and so
that each takes one CTA: the kernel's device time per launch from the
profiler, each launch checked against the plain version.  Prints one JSON
line per shape and, last, the smallest number of stacks from which one
CTA a stack was at least as fast in every shape timed at that many stacks
or more (null where no such number was timed).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

#: (name, shape (n_coef, n_ntt, terms, groups, primes) without groups,
#: the groups swept): the tensor product at the chain's three primes, and
#: one product of two coefficient rows at one prime
SWEEP = (("tensor", (4, 0, "TENSOR_TERMS", 3),
          (24, 44, 88, 128, 176, 256, 512, 1366)),
         ("one_product", (2, 0, "ONE_TERM", 1),
          (72, 132, 264, 528, 1056, 2048, 4096)))
#: MUL_SPREAD_LIMIT values that give every stack a cluster / one CTA
CLUSTERS, ONE_CTA = 1 << 62, 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the results to this file")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("ntt_mul_spread: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels.ntt import ops as nops
    from repro_torch.protocols.ckks import cipher as ck

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    shapes = {}
    for job in (cs.CKKS_MAIN, cs.CKKS_STATS):
        counts = cs._ckks_checked_run(job, dev)[3]
        for key, k in counts["mul_shapes"].items():
            name = f"{job['workload']} x{k}"
            shapes[key] = f"{shapes[key]}, {name}" if key in shapes else name
    for name, (c, m, terms, p), groups in SWEEP:
        for g in groups:
            key = (c, m, getattr(ck, terms), g, p)
            shapes.setdefault(key, f"{name} sweep")
    rng = np.random.default_rng(17)
    rows = []
    for key, where in sorted(shapes.items(), key=lambda kv: kv[0][3]
                             * kv[0][4]):
        ms = {}
        for side, limit in (("clusters", CLUSTERS), ("one_cta", ONE_CTA)):
            nops.MUL_SPREAD_LIMIT = limit
            nops._mul_plans.clear()
            ms[side] = cs._mul_timing(key, cs.BENCH_CKKS.n_ring, dev, rng,
                                      args.reps, replaced=False)["ms"]
        row = {"coef": key[0], "ntt": key[1], "outputs": len(key[2]),
               "groups": key[3], "primes": key[4],
               "stacks": key[3] * key[4], "from": where,
               "clusters_ms": ms["clusters"], "one_cta_ms": ms["one_cta"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    crossover = None
    for r in sorted(rows, key=lambda r: -r["stacks"]):
        above = [x for x in rows if x["stacks"] >= r["stacks"]]
        if all(x["one_cta_ms"] <= x["clusters_ms"] for x in above):
            crossover = r["stacks"]
        else:
            break
    out = {"card": card, "shapes": rows, "one_cta_from_stacks": crossover}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"card": card, "one_cta_from_stacks": crossover}))


if __name__ == "__main__":
    main()
