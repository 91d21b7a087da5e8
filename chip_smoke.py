#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each raising on failure:

1. device   the card's name and power limit (nvidia-smi);
2. build    the half-gates CUDA kernels from the sources in the checkout;
3. kernels  each kernel against its plain PyTorch version on the card,
            bit for bit, at the main path's launch sizes and beyond, gate
            ids up to 2^40, all four truth-table rows; timings;
4. parity   a small planned two-party merge on the card equals the same
            job run with device="cpu" (outputs, AND count, table digest);
5. main     the planned two-party merge at n=16384 records per party on
            the card, checked against the workload's oracle, with swap
            traffic and every AND gate through the kernels;
6. record   each kernel timed at the main path's launch sizes, beside its
            bound and its plain version;
7. profile  the main path's shape at n=1024 under torch.profiler: device
            time by op, and the device's busy share.

The last four lines are a JSON summary of the run's headline numbers, the
card's name and power limit, the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import JobSpec, Session  # noqa: E402
from repro_torch.kernels.garble import kernel as gk, ops, ref  # noqa: E402

#: H100 SXM peaks: HBM3 bandwidth (NVIDIA data sheet), and 32-bit
#: three-input logic operations (LOP3) per second: 64 per SM per clock (CUDA
#: C++ programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
LOP3_PER_S = 132 * 64 * 1.98e9

KERNEL_SIZES = (1, 16, 32, 37, 64, 4096, 1 << 20)
GIDS = (0, (1 << 31) + 5, 1 << 40)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    gk.library()
    info = gk.build_info()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {info.seconds:.2f} s)"
        f" -> {os.path.relpath(info.path, ROOT)}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def _labels(rng: np.random.Generator, m: int, dev) -> torch.Tensor:
    x = rng.integers(0, 1 << 64, (m, 2), dtype=np.uint64)
    return torch.from_numpy(x.view(np.int64)).to(dev)


def _max_abs_err(outs, plains) -> int:
    """Largest |kernel - plain| over the compared 64-bit words, each read
    as unsigned (the labels' and tables' bit views)."""
    err = 0
    for k, p in zip(outs, plains):
        a = k.cpu().numpy().view(np.uint64)
        b = p.cpu().numpy().view(np.uint64)
        if a.size:
            err = max(err, int(np.max(np.where(a > b, a - b, b - a))))
    return err


def _device_ms(fn, reps: int) -> float:
    """Median device time of one call, from CUDA events around ``reps``
    back-to-back calls (five rounds, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        rounds.append(start.elapsed_time(stop) / reps)
    return statistics.median(rounds)


def _kernel_ms(fn, name: str, reps: int) -> float | None:
    """Mean duration of the kernel ``name`` on the device over ``reps``
    calls, from the profiler's CUDA trace; None if the trace shows none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    tot = cnt = 0
    for ev in prof.key_averages():
        if name in ev.key:
            tot += getattr(ev, "device_time_total", 0) or \
                getattr(ev, "cuda_time_total", 0)
            cnt += ev.count
    return tot / cnt / 1e3 if cnt and tot else None


def phase_kernels(dev) -> tuple[dict, dict]:
    """Kernels against their plain versions, bit for bit, then each one's
    time at the main path's launch sizes and at 2^20 gates.  Returns each
    kernel's max_abs_err over the comparisons, and its ms at 2^20."""
    rng = np.random.default_rng(2024)
    checked = 0
    errs = {"garble_and": 0, "eval_and": 0}
    big = {}
    for m in KERNEL_SIZES:
        a, b = _labels(rng, m, dev), _labels(rng, m, dev)
        r = rng.integers(0, 1 << 64, 2, dtype=np.uint64)
        r[0] |= np.uint64(1)
        rt = torch.from_numpy(r.view(np.int64).copy()).to(dev)
        for gid0 in GIDS:
            c, tab = ops.garble_and(a, b, r, gid0)
            err = _max_abs_err((c, tab), ref.garble_and(a, b, rt, gid0))
            errs["garble_and"] = max(errs["garble_and"], err)
            if err:
                raise AssertionError(f"garble_and != plain at m={m} "
                                     f"gid0={gid0}: max_abs_err {err}")
            for bit_a in (0, 1):
                for bit_b in (0, 1):
                    wa = a ^ (rt * bit_a)
                    wb = b ^ (rt * bit_b)
                    w = ops.eval_and(wa, wb, tab, gid0)
                    err = _max_abs_err((w,), (ref.eval_and(wa, wb, tab,
                                                           gid0),))
                    errs["eval_and"] = max(errs["eval_and"], err)
                    if err:
                        raise AssertionError(f"eval_and != plain at m={m} "
                                             f"gid0={gid0}: max_abs_err "
                                             f"{err}")
                    if not torch.equal(w, c ^ (rt * (bit_a & bit_b))):
                        raise AssertionError(
                            f"truth table row ({bit_a},{bit_b}) fails at "
                            f"m={m} gid0={gid0}")
            checked += 1
    torch.cuda.synchronize()
    log(f"kernels: garble_and and eval_and equal their plain versions bit "
        f"for bit (tolerance 0: integer crypto) at m in {KERNEL_SIZES} x "
        f"gid0 in {GIDS}, all four truth-table rows ({checked} cases)")

    for m in (16, 32, 64, 1 << 20):
        a, b = _labels(rng, m, dev), _labels(rng, m, dev)
        r = rng.integers(0, 1 << 64, 2, dtype=np.uint64)
        rt = torch.from_numpy(r.view(np.int64).copy()).to(dev)
        _, tab = ops.garble_and(a, b, r, 7)
        reps = 20 if m > 4096 else 500
        fns = {
            "garble_and": (lambda: ops.garble_and(a, b, r, 7),
                           lambda: ref.garble_and(a, b, rt, 7),
                           "garble_and_kernel", gk.GARBLE_LOP3_PER_AND,
                           gk.GARBLE_BYTES_PER_AND),
            "eval_and": (lambda: ops.eval_and(a, b, tab, 7),
                         lambda: ref.eval_and(a, b, tab, 7),
                         "eval_and_kernel", gk.EVAL_LOP3_PER_AND,
                         gk.EVAL_BYTES_PER_AND),
        }
        for name, (kfn, pfn, kname, lop3, nbytes) in fns.items():
            event_ms = _device_ms(kfn, reps)
            kernel_ms = _kernel_ms(kfn, kname, reps)
            plain_ms = _device_ms(pfn, max(reps // 50, 2))
            bound_ms = max(m * lop3 / LOP3_PER_S,
                           m * nbytes / HBM_BYTES_PER_S) * 1e3
            ms = kernel_ms or event_ms
            log(f"  {name} m={m}: kernel {kernel_ms} ms (profiler), "
                f"{event_ms:.4f} ms per call (events), bound "
                f"{bound_ms:.3e} ms ({bound_ms / ms:.3g} of it), plain "
                f"{plain_ms:.4f} ms, {m / ms * 1e3:.3e} ANDs/s")
            if m == 1 << 20:
                big[name] = {"ms": ms, "bound_ms": bound_ms,
                             "plain_ms": plain_ms}
    return errs, big


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------

#: the main path: the JAX package's Fig. 8 merge case (benchmarks/fig8_swap.py)
MAIN = dict(n=16384, memory_budget=0.4, lookahead=10_000, prefetch_pages=64)
#: small enough to run on the CPU too, with a budget that forces swaps
PARITY = dict(n=256, memory_budget=0.4, lookahead=10_000, prefetch_pages=8)
#: no prefetch buffer: the plan keeps synchronous SWAP_IN / SWAP_OUT
SYNC_SWAPS = dict(PARITY, memory_budget=12, prefetch_pages=0)
#: the main path's shape at a sixteenth of its size, run under the profiler:
#: 0.4 of its working set of 66 pages as a frame count (a fractional budget
#: would be raised to the floor of 8 + prefetch frames, above the working set)
PROFILED = dict(n=1024, memory_budget=26, lookahead=10_000, prefetch_pages=6)


def _run(job: dict, device, digest: bool = False):
    s = Session(JobSpec("merge", **job), device=device)
    t0 = time.perf_counter()
    out = s.execute(real=True, check=True, digest=digest)
    return s, out, time.perf_counter() - t0


def _swaps(s) -> tuple[int, int, int, int]:
    st = s.engine_stats
    return (sum(e.swap_ins for e in st), sum(e.swap_outs for e in st),
            sum(e.io_read_bytes for e in st),
            sum(e.io_write_bytes for e in st))


def phase_parity(dev) -> dict:
    gpu, out_g, t_g = _run(PARITY, dev, digest=True)
    cpu, out_c, t_c = _run(PARITY, "cpu", digest=True)
    if _swaps(gpu)[0] == 0:
        raise AssertionError("parity job did not swap")
    if sorted(out_g) != sorted(out_c) or \
            not all(np.array_equal(out_g[k], out_c[k]) for k in out_g):
        raise AssertionError("card and CPU outputs differ")
    ands = [g.ands for g in gpu.gate_counts]
    if ands != [g.ands for g in cpu.gate_counts] or ands[0] != ands[1]:
        raise AssertionError(f"AND counts differ: {ands} vs "
                             f"{[g.ands for g in cpu.gate_counts]}")
    if gpu.table_digest != cpu.table_digest:
        raise AssertionError("garbled-table streams differ")
    log(f"parity: merge n={PARITY['n']} on the card ({t_g:.2f} s) == on the "
        f"CPU ({t_c:.2f} s): {len(out_g)} outputs, {ands[0]} ANDs, table "
        f"sha256 {gpu.table_digest[:16]}, swaps in/out "
        f"{_swaps(gpu)[:2]}")
    sync, _, t_s = _run(SYNC_SWAPS, dev)
    if _swaps(sync)[0] == 0 or sync.plan_reports[0].schedule.prefetched:
        raise AssertionError("the synchronous-swap job made no sync swaps")
    log(f"sync swaps: merge n={SYNC_SWAPS['n']} with SWAP_IN/SWAP_OUT only, "
        f"on the card ({t_s:.2f} s), checked against the oracle; swaps "
        f"in/out {_swaps(sync)[:2]}")
    return {"card_s": t_g, "cpu_s": t_c, "sync_card_s": t_s}


def phase_main(dev) -> tuple[dict, dict]:
    """The main path; returns the kernels' counts from its run and its
    end-to-end metrics."""
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_counts()
    s, out, seconds = _run(MAIN, dev)
    counts = ops.counts()
    ins, outs, rbytes, wbytes = _swaps(s)
    if ins == 0 or outs == 0:
        raise AssertionError("main path did not swap")
    g_ands, e_ands = (g.ands for g in s.gate_counts)
    if counts["garble_ands"] != g_ands or counts["eval_ands"] != e_ands:
        raise AssertionError(f"ANDs through the kernels {counts} != gate "
                             f"counts {g_ands}, {e_ands}")
    t = s.timings
    table_bytes = sum(v.bytes for k, v in s.transport_stats.items()
                      if k[2] == 1)
    log(f"main: merge n={MAIN['n']} per party, budget {MAIN['memory_budget']}"
        f" of the working set ({s.config.num_frames} frames, "
        f"{s.config.prefetch_pages} prefetch), {len(out)} output chunks "
        f"checked against the oracle")
    log(f"  seconds: trace {t['trace_s']:.3f}, plan {t['plan_s']:.3f}, "
        f"batch schedule {t['batch_schedule_s']:.3f}, execute "
        f"{t['execute_s']:.3f} (all {seconds:.3f})")
    log(f"  AND gates {g_ands} per party, {g_ands / t['execute_s']:.4e} "
        f"AND gates/s end to end; table bytes {table_bytes}")
    log(f"  swaps: {ins} in / {outs} out, {rbytes} / {wbytes} bytes "
        f"(both parties)")
    log(f"  frame memory {s.engine_stats[0].frame_bytes} bytes per party, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} bytes")
    log(f"  launches: garble_and {counts['garble_launches']}, eval_and "
        f"{counts['eval_launches']}; sizes "
        f"{sorted(counts['launch_sizes']['garble'].items())[:8]}")
    metrics = {"n": MAIN["n"], **t, "ands": g_ands,
               "ands_per_s": g_ands / t["execute_s"],
               "table_bytes": table_bytes, "swaps": [ins, outs],
               "swap_bytes": [rbytes, wbytes],
               "frame_bytes": s.engine_stats[0].frame_bytes,
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    return counts, metrics


def _dev_us(ev) -> float:
    return getattr(ev, "self_device_time_total", None) or \
        getattr(ev, "self_cuda_time_total", 0)


def phase_profile(dev) -> dict:
    """Where the device's time goes on the main path's shape: the device
    time of every CUDA op (kernels and copies) under torch.profiler, and
    their sum against the wall time of the execute stage.  The profiler
    slows the host, so the busy share is a lower bound on the unprofiled
    run's."""
    from torch.profiler import ProfilerActivity, profile
    s = Session(JobSpec("merge", **PROFILED), device=dev)
    s.plan()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.execute(real=True, check=True)
    wall_ms = s.timings["execute_s"] * 1e3
    evs = sorted(prof.key_averages(), key=_dev_us, reverse=True)
    busy_ms = sum(_dev_us(e) for e in evs) / 1e3
    log(f"profile: merge n={PROFILED['n']}, execute {wall_ms:.1f} ms under "
        f"the profiler, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.3f} of it; idle share "
        f"{1 - busy_ms / wall_ms:.3f})")
    for e in evs[:8]:
        log(f"  {_dev_us(e) / 1e3:10.2f} ms  {e.count:8d}x  {e.key[:70]}")
    return {"n": PROFILED["n"], "execute_ms": wall_ms, "busy_ms": busy_ms}


def kernel_record(dev, counts: dict, errs: dict) -> list[dict]:
    """Time each kernel at every launch size the main path used and report
    launch-weighted means beside the bound and the plain version;
    ``errs`` holds the kernels phase's max_abs_err, which the comparisons
    here extend."""
    rng = np.random.default_rng(7)
    rows = []
    spec = {"garble_and": ("garble", "garble_and_kernel", 151,
                           gk.GARBLE_LOP3_PER_AND, gk.GARBLE_BYTES_PER_AND),
            "eval_and": ("eval", "eval_and_kernel", 175,
                         gk.EVAL_LOP3_PER_AND, gk.EVAL_BYTES_PER_AND)}
    for name, (kind, kname, line, ops_g, bytes_g) in spec.items():
        sizes = counts["launch_sizes"][kind]
        total = sum(sizes.values())
        ms = plain = bound = 0.0
        bound_ops = bound_bytes = 0.0
        for m, k in sizes.items():
            a, b = _labels(rng, m, dev), _labels(rng, m, dev)
            r = rng.integers(0, 1 << 64, 2, dtype=np.uint64)
            rt = torch.from_numpy(r.view(np.int64).copy()).to(dev)
            _, tab = ref.garble_and(a, b, rt, 3)
            if kind == "garble":
                kfn = lambda: ops.garble_and(a, b, r, 3)  # noqa: E731
                pfn = lambda: ref.garble_and(a, b, rt, 3)  # noqa: E731
                err = _max_abs_err(kfn(), pfn())
            else:
                kfn = lambda: ops.eval_and(a, b, tab, 3)  # noqa: E731
                pfn = lambda: ref.eval_and(a, b, tab, 3)  # noqa: E731
                err = _max_abs_err((kfn(),), (pfn(),))
            errs[name] = max(errs[name], err)
            if err:
                raise AssertionError(f"{name} != plain at m={m}: "
                                     f"max_abs_err {err}")
            km = _kernel_ms(kfn, kname, 200) or _device_ms(kfn, 200)
            w = k / total
            ms += w * km
            plain += w * _device_ms(pfn, 20)
            bound_ops += w * m * ops_g / LOP3_PER_S * 1e3
            bound_bytes += w * m * bytes_g / HBM_BYTES_PER_S * 1e3
        bound = max(bound_ops, bound_bytes)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/garble/csrc/garble.cu",
            "replaces": f"src/repro/kernels/garble/kernel.py:{line}",
            "launches": counts[f"{kind}_launches"],
            "max_abs_err": float(errs[name]),
            "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "operations" if bound_ops >= bound_bytes
            else "bytes",
            "library_ms": None})
        log(f"  {name} over the main path's launch sizes "
            f"{dict(sorted(sizes.items()))}: {ms:.5f} ms per launch "
            f"(bound {bound:.3e} ms, plain {plain:.4f} ms)")
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    phases = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        log(f"[{name}: {phases[name]:.2f} s]")
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    errs, big = timed("kernels", phase_kernels, dev)
    parity = timed("parity", phase_parity, dev)
    counts, metrics = timed("main", phase_main, dev)
    rows = timed("record", kernel_record, dev, counts, errs)
    profiled = timed("profile", phase_profile, dev)
    # the run's headline numbers, kept near the end of the output
    log("summary: " + json.dumps({
        "main": metrics, "m=2^20": big, "parity": parity,
        "profile": profiled, "total_s": time.perf_counter() - t_all}))
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
