#!/usr/bin/env python3
"""The dry run's sweep as a markdown table, from its artifacts:

    python3 tools/dryrun_table.py [DIR] [--variant V]

DIR defaults to ``experiments/dryrun_torch`` (what ``python -m
repro_torch.launch.dryrun --all`` and ``--all --multi-pod`` write).  A row
an arch, a column a shape of ``configs.SHAPES``; a cell of
``configs.all_cells()`` reads "pod256 / pod512", each the analytic
roofline's dominant term and fraction and the per-rank GB (arguments +
the step's peak of bytes made), or FAIL with the op or check that failed
(the first line of its error, shortened); a shape the arch does not run
is "-".  Dominant terms: comp(ute), mem(ory), coll(ective).  The
roofline's seconds are model outputs with H100 constants, not device
times.
"""

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


SHORT = {"compute": "comp", "memory": "mem", "collective": "coll"}


def failed_op(err: str) -> str:
    """The op DTensor had no strategy for, else the error's first line."""
    m = re.search(r"propagation failed for (aten\.[\w.]+)", err)
    if m:
        return f"no sharding for `{m.group(1)}`"
    if err.startswith("TimeoutError"):
        return "time limit"
    line = err.splitlines()[0] if err else "?"
    return line[:60].replace("|", "/")


def cell(path: str) -> str:
    if not os.path.exists(path):
        return "not run"
    with open(path) as f:
        r = json.load(f)
    if not r["ok"]:
        return f"FAIL ({failed_op(r.get('error', ''))})"
    roof, mem = r["roofline"], r["memory"]
    per_rank = mem["argument_bytes"] + mem["temp_bytes"]
    return (f"{SHORT[roof['dominant']]} {roof['roofline_fraction']:.3f} "
            f"{per_rank / 1e9:.1f} GB")


def main() -> None:
    from repro_torch.configs import ARCHS, SHAPES, all_cells
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", nargs="?",
                    default=os.path.join(ROOT, "experiments", "dryrun_torch"))
    ap.add_argument("--variant", default="")
    args = ap.parse_args()
    suffix = f"__{args.variant}" if args.variant else ""
    cells = set(all_cells())
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    for arch in ARCHS:
        row = [" / ".join(cell(os.path.join(
            args.dir, f"{arch}__{shape}__{mesh}{suffix}.json"))
            for mesh in ("pod256", "pod512"))
            if (arch, shape) in cells else "-" for shape in SHAPES]
        print(f"| {arch} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main()
