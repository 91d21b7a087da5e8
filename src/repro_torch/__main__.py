"""``python -m repro_torch``: the port's deployment CLI (the paper's §6
"plan, then execute", and §5.2's unit of one engine a process).

    python -m repro_torch plan --workload merge -n 256 --budget 0.4 \\
        --prefetch 8 --out job/ [--mode memory] [--device cpu]
    python -m repro_torch run job/ --real --check [--device cpu]
    python -m repro_torch run job/ --worker 1 --peers h0:9000,h1:9001 \\
        [--json rank1.json] [--device cpu]
    python -m repro_torch fabric job/ --real --check [--json merged.json] \\
        [--device cpu]
    python -m repro_torch exec --workload merge -n 16384 --budget 0.4 \\
        --prefetch 64 --lookahead 10000 --real --check [--device cpu]
    python -m repro_torch exec --workload rmvmul -n 24 --budget 0.4 \\
        --prefetch 8 --ckks-ring 1024 --check [--device cpu]
    python -m repro_torch exec --workload merge -n 256 --workers 4 \\
        --budget 0.4 --prefetch 16 --exec-backend overlap --real --check \\
        [--parallel thread] [--device cpu]
    python -m repro_torch exec --workload shamir_stats -n 2048 --workers 3 \\
        --budget 0.5 --exec-backend overlap --check [--device cpu]
    python -m repro_torch bench [--tiny] [--cases merge=16384,rsum=256] \\
        [--streaming] [--sweep] [--json rows.json] [--cache DIR] \\
        [--device cpu]
    python -m repro_torch agg --clients 2000 --rounds 3 --check \\
        [--rank K --peers h0:p0,...] [--drop R:c1,c2] [--json o.json] \\
        [--device cpu]
    python -m repro_torch serve --cache DIR --socket /tmp/mage.sock \\
        [--device cpu]
    python -m repro_torch submit --connect /tmp/mage.sock --workload merge \\
        -n 4096 --budget 0.4 [--execute --check] [--status] [--shutdown]

``plan`` traces and plans a job and saves it: ``workerK.memory.bc``
program files (an unbounded job's traced programs) and a ``job.json``
manifest, in the JAX package's format, with the spec's hash stamped into
every program; as the reference's ``plan`` does, it plans out of core by
default (``--mode streaming``: the planner writes each memory program
file to file).  ``run`` executes a saved plan, from either package, after
checking that hash (a mismatch exits 2), its program files read a chunk
at a time and never whole: every rank in this process by
default, over ``--transport`` (inproc, tcp, shaped or shaped+tcp), or
with ``--worker K --peers ...`` only global rank K (party * workers +
worker) against peers over TCP.  ``fabric`` launches the whole fleet, one
``run --worker K`` process a rank on localhost, kills it if a rank fails
or outlasts ``--timeout``, and merges and checks the outputs.  ``exec``
traces, plans and executes in one process and prints a JSON summary:
timings, swap traffic, the engine's frame bytes, outputs, and for a
garbled-circuit job run with ``--real`` its AND gates, for a CKKS job its
instructions, homomorphic ops per second and transforms.  A Shamir job
(``shamir_stats``, ``shamir_cmp``) runs its n parties as ``--workers n``
(the ``shamir`` driver; ``run`` and ``fabric`` also take ``--driver
shamir-3party`` / ``shamir-5party``, which check the count).  ``bench``
drives the §8.2 scenarios (unbounded, OS swapping, MAGE) through the
timing simulator, as the JAX package's ``bench`` does, and asserts that
MAGE beats OS swapping on every case (not with ``--tiny`` or
``--no-check``); its seconds are outputs of the cost and storage models,
the same on every host, and only the planning columns are measured.

``--cache DIR`` (``plan``, ``exec``, ``bench``) serves repeated job
shapes from an artifact cache: traced programs, plans and schedules,
validated on every hit (the JAX package's entries hit too).  ``agg``
runs secure aggregation: many input-only clients, over a few gateway
endpoints, stream additive shares to a small compute fleet whose share
matrices and sums live on the card (``--rank K --peers ...``: one rank a
process over TCP); ``--check`` holds every round to the oracle (exit 1
if it differs).  ``serve`` runs the multi-tenant plan-cache daemon (its
jobs on the card) and ``submit`` sends it jobs, ``--status`` or
``--shutdown`` (exit 3 when admission rejects the job, 1 on another
error), with the reference's line-delimited JSON protocol and
envelopes.

The knobs are the JAX package's: ``--mode`` (memory; streaming, the
same plan made out of core and run from its files; or unbounded: the
traced program over the whole virtual address space, no budget; the
default is unbounded without ``--budget``, else streaming for ``plan``
and memory for ``exec``), ``--policy``,
``--swap-bypass``, ``--exec-backend`` (batched by default, scalar, or
overlap), ``--storage`` (ram: pinned host pages, or memmap: a swap file),
``--workers`` (engines per party, which exchange values over NET_*
directives) and ``--parallel`` (how the workers' programs are planned:
serial, thread or process).  Garbled circuits run with real two-party
crypto with ``--real``, and otherwise in the clear through the plaintext
oracle driver; CKKS is real crypto either way.  Every entry point runs on
the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .api import (SCHEMA_VERSION, JobSpec, Session, SpecMismatchError,
                  check_outputs, driver_parties, load_manifest, oracle_extra)
from .core.transport import (FabricSpec, TransportError, aggregate_links,
                             pick_free_ports)
from .kernels import kernel_counts
from .kernels.garble import ops as gc_ops
from .kernels.ntt import ops as ntt_ops
from .protocols.ckks.driver import homomorphic_ops
from .workloads import all_names, get as get_workload

#: the drivers ``run`` and ``fabric`` take by name
DRIVER_CHOICES = ("gc-plaintext", "gc-2party", "ckks", "shamir",
                  "shamir-3party", "shamir-5party")


def _parse_budget(text: str) -> int | float:
    """``12`` → 12 frames; ``0.25`` → fraction of the working set."""
    if any(c in text for c in ".eE"):
        return float(text)
    return int(text)


def _spec_from_args(args: argparse.Namespace,
                    default_mode: str = "memory") -> JobSpec:
    mode = args.mode or (default_mode if args.budget is not None
                         else "unbounded")
    return JobSpec(args.workload, n=args.n, num_workers=args.workers,
                   parallel_plan=args.parallel, memory_budget=args.budget,
                   lookahead=args.lookahead, prefetch_pages=args.prefetch,
                   policy=args.policy, swap_bypass=args.swap_bypass,
                   plan_mode=mode, exec_backend=args.exec_backend,
                   storage=args.storage, ckks_ring=args.ckks_ring,
                   ckks_levels=args.ckks_levels)


def _links(stats) -> dict:
    return {f"{src}->{dst}": [t.messages, t.bytes] for (src, dst), t
            in sorted(aggregate_links(stats).items())}


# ---------------------------------------------------------------------------
# plan / run / fabric
# ---------------------------------------------------------------------------


def cmd_plan(args) -> int:
    spec = _spec_from_args(args, default_mode="streaming")
    with Session(spec, device=args.device, cache=args.cache) as s:
        manifest = s.save_plan(args.out)
        for i, prog in enumerate(s.plan()):
            print(f"worker{i}: {len(prog)} instructions ({prog.phase}) -> "
                  f"{os.path.join(args.out, f'worker{i}.memory.bc')}")
        if s.cache_events:
            print(f"cache: {s.cache_events}")
        print(f"spec hash {s.spec.plan_hash(s.workload)} "
              f"({s.spec.plan_mode}); manifest: {manifest}")
    return 0


def _rank_report(s: Session) -> dict:
    """What a rank ran and where: its device, timings, traffic, AND
    gates and table digests, its peak device memory, and the kernels'
    counters of this process, set to 0 just before the run (every rank
    must show its AND gates and NTTs through the kernels)."""
    return {"hosted": s.hosted, "device": str(s.device),
            "driver": s.driver_name, "timings": s.timings,
            "and_gates": [g.ands for g in s.gate_counts],
            "table_digests": {f"{a}->{b}": d
                              for (a, b), d in s.table_digests.items()},
            "kernel_counts": kernel_counts(),
            "links": _links(s.transport_stats),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(s.device)
                                     if s.device.type == "cuda" else None)}


def cmd_run(args) -> int:
    transport = args.transport
    if args.latency or args.bandwidth:
        if transport not in ("shaped", "shaped+tcp"):
            raise SystemExit("error: --latency/--bandwidth need "
                             "--transport shaped or shaped+tcp")
    if args.worker is not None:
        if not args.peers:
            raise SystemExit("error: --worker needs --peers host:port,... "
                             "(one address per global rank)")
        if args.check:
            raise SystemExit("error: --check needs the full outputs; a "
                             "--worker rank only holds its own (use "
                             "`python -m repro_torch fabric` instead)")
        transport = transport or "tcp"
    fabric = FabricSpec(rank=args.worker,
                        peers=tuple(args.peers.split(",")) if args.peers
                        else (), latency_s=args.latency,
                        bandwidth=args.bandwidth)
    sess = Session.from_plan(args.jobdir, storage=args.storage,
                             driver=args.driver,
                             transport=transport or "inproc",
                             fabric=fabric, device=args.device)
    if args.exec_backend is not None:
        # the engine loop never changes outputs and is not plan-hashed
        sess.spec = dataclasses.replace(sess.spec,
                                        exec_backend=args.exec_backend)
    gc_ops.reset_counts()
    ntt_ops.reset_counts()
    if sess.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(sess.device)
    outputs = sess.execute(real=args.real or None, check=args.check,
                           digest=args.digest)
    report = _rank_report(sess)
    report["rank"] = args.worker
    for tag in sorted(outputs)[:4]:
        v = np.asarray(outputs[tag])
        head = ", ".join(str(x) for x in v.flat[:4])
        print(f"output[{tag}]: shape={v.shape} "
              f"[{head}{', ...' if v.size > 4 else ''}]")
    where = "all ranks" if args.worker is None else f"rank {args.worker}"
    print(f"run: {len(outputs)} outputs from {where} on {report['device']} "
          f"over {sess.spec.transport}; execute "
          f"{sess.timings['execute_s']:.3f} s; AND gates "
          f"{report['and_gates']}")
    if args.json:
        _dump(args.json, outputs, report=report)
        print(f"wrote {args.json}")
    if args.check:
        print("oracle check OK")
    return 0


def _dump(path: str, outputs: dict, **extra) -> None:
    with open(path, "w") as f:
        json.dump({"schema_version": SCHEMA_VERSION,
                   "outputs": {str(tag): np.asarray(v).tolist()
                               for tag, v in outputs.items()}, **extra}, f)


def _load(path: str, protocol: str) -> tuple[dict, dict]:
    """A ``--json`` file's outputs (as arrays) and the rest of it."""
    with open(path) as f:
        doc = json.load(f)
    dtype = np.float64 if protocol == "ckks" else np.uint64
    outs = {int(tag): np.asarray(v, dtype=dtype)
            for tag, v in doc.pop("outputs").items()}
    return outs, doc


def cmd_fabric(args) -> int:
    """One ``run --worker K`` process a global rank on localhost."""
    manifest, spec = load_manifest(args.jobdir)
    w = get_workload(spec.workload)
    spec = spec.normalized(w)
    driver = args.driver or spec.driver
    if args.real and w.protocol == "gc":
        driver = "gc-2party"
    n_ranks = driver_parties(driver) * spec.num_workers
    peers = ",".join(f"127.0.0.1:{p}" for p in pick_free_ports(n_ranks))
    print(f"fabric: {n_ranks} ranks ({driver}) over {peers}", flush=True)
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    outputs: dict = {}
    reports = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mage_fabric_") as outdir:
        procs = []
        try:
            for rank in range(n_ranks):
                out_json = os.path.join(outdir, f"rank{rank}.json")
                cmd = [sys.executable, "-m", "repro_torch", "run",
                       args.jobdir, "--worker", str(rank), "--peers", peers,
                       "--json", out_json]
                for flag, value in (("--driver", driver),
                                    ("--storage", args.storage),
                                    ("--device", args.device)):
                    if value is not None:
                        cmd += [flag, value]
                if args.digest:
                    cmd.append("--digest")
                procs.append((rank, out_json,
                              subprocess.Popen(cmd, env=env)))
            failed = _wait_fleet(procs, args.timeout)
        finally:
            for _, _, proc in procs:      # no rank outlives the launcher
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        if failed:
            raise SystemExit(f"error: fabric ranks failed: {failed}")
        for rank, out_json, _ in procs:
            outs, doc = _load(out_json, w.protocol)
            outputs.update(outs)
            reports.append(doc["report"])
    seconds = time.perf_counter() - t0
    for rep in reports:
        kc = rep["kernel_counts"]
        print(f"fabric: rank {rep['rank']} on {rep['device']}: execute "
              f"{rep['timings']['execute_s']:.3f} s, AND gates "
              f"{rep['and_gates']}, launches garble/eval "
              f"{kc['gc']['garble_launches']}/{kc['gc']['eval_launches']}, "
              f"NTT {sum(kc['ntt']['launches'].values())}")
    print(f"fabric: merged {len(outputs)} outputs from {n_ranks} ranks in "
          f"{seconds:.2f} s")
    if args.json:
        _dump(args.json, outputs, ranks=reports, seconds=seconds,
              driver=driver)
        print(f"wrote {args.json}")
    if args.check:
        check_outputs(w, spec.n, outputs, **oracle_extra(w, spec))
        print("oracle check OK")
    return 0


def _wait_fleet(procs: list, timeout: float) -> list:
    """Wait for every rank; a rank that exits non-zero or outlasts
    ``timeout`` fails the fleet, and the rest are killed at once (their
    peers would wait on it until their receive timeouts)."""
    deadline = time.monotonic() + timeout
    running = {rank: proc for rank, _, proc in procs}
    failed = []
    while running and not failed:
        for rank, proc in list(running.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del running[rank]
            if rc != 0:
                failed.append((rank, rc))
        if running and time.monotonic() > deadline:
            failed += [(rank, f"timeout after {timeout}s")
                       for rank in running]
        time.sleep(0.05)
    if failed:
        for proc in running.values():
            proc.kill()
    return failed


# ---------------------------------------------------------------------------
# exec: trace, plan and execute in one process
# ---------------------------------------------------------------------------


def _protocol_summary(s: Session, real: bool) -> dict:
    t = s.timings["execute_s"]
    if s.protocol == "ckks":
        he = homomorphic_ops(s.op_counts)
        p = s.ckks_params()
        return {"ckks": {"n_ring": p.n_ring, "levels": p.levels},
                "instructions": [e.instructions for e in s.engine_stats],
                "op_counts": s.op_counts,
                "homomorphic_ops": he, "homomorphic_ops_per_s": he / t,
                "transforms": {k: s.ckks_counts.get(k, 0)
                               for k in ("ntt_forward", "ntt_inverse")},
                "mul_mod_rows": s.ckks_counts.get("mul_mod", 0)}
    if s.protocol == "shamir":
        return {"driver": s.driver_name,
                "instructions": [e.instructions for e in s.engine_stats]}
    if not real:
        return {"driver": "gc-plaintext",
                "instructions": [e.instructions for e in s.engine_stats]}
    ands = s.gate_counts[0].ands
    return {"driver": "gc-2party", "and_gates": ands,
            "and_gates_per_s": ands / t}


def cmd_exec(args) -> int:
    try:
        spec = _spec_from_args(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    with Session(spec, device=args.device, cache=args.cache) as s:
        out = s.execute(real=args.real, check=args.check)
    summary = {
        "device": str(s.device),
        "cache": s.cache_events,
        "spec": {"workload": s.spec.workload, "n": s.spec.n,
                 "plan_mode": s.spec.plan_mode,
                 "memory_budget": s.spec.memory_budget,
                 "num_frames": s.config.num_frames if s.config else None,
                 "prefetch_pages": s.config.prefetch_pages if s.config
                 else None, "lookahead": s.spec.lookahead,
                 "policy": s.spec.policy, "swap_bypass": s.spec.swap_bypass,
                 "exec_backend": s.spec.exec_backend,
                 "storage": s.spec.storage,
                 "num_workers": s.spec.num_workers,
                 "parallel_plan": s.spec.parallel_plan},
        "timings_s": s.timings,
        **_protocol_summary(s, args.real),
        "swap_ins": [e.swap_ins for e in s.engine_stats],
        "swap_outs": [e.swap_outs for e in s.engine_stats],
        "frame_bytes": [e.frame_bytes for e in s.engine_stats],
        "net_messages": [e.net_messages for e in s.engine_stats],
        "posted_recvs": [e.posted_recvs for e in s.engine_stats],
        "max_inflight_recvs": [e.max_inflight_recvs
                               for e in s.engine_stats],
        "links": _links(s.transport_stats),
        "outputs": len(out),
        "checked": bool(args.check),
    }
    text = json.dumps(summary, indent=2)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    return 0


# ---------------------------------------------------------------------------
# bench: the §8.2 scenarios through the timing simulator
# ---------------------------------------------------------------------------


def cmd_bench(args) -> int:
    from .scenarios import (BENCH_CASES, STREAMING_CASE, SWEEP_BUDGETS,
                            SWEEP_LOOKAHEADS, TINY_BENCH_CASES,
                            TINY_STREAMING_CASE, run_bench, run_sweep)
    if args.cases:
        cases = []
        for item in args.cases.split(","):
            name, _, n = item.partition("=")
            if not name or not n.isdigit():
                raise SystemExit(
                    f"error: bad --cases entry {item!r} (want workload=n, "
                    f"e.g. merge=16384)")
            cases.append((name, int(n)))
    else:
        cases = TINY_BENCH_CASES if args.tiny else BENCH_CASES
    if args.sweep:
        budgets = tuple(float(b) for b in args.budgets.split(",")) \
            if args.budgets else SWEEP_BUDGETS
        lookaheads = tuple(int(x) for x in args.lookaheads.split(",")) \
            if args.lookaheads else SWEEP_LOOKAHEADS
        rows = run_sweep(cases=cases, budgets=budgets,
                         lookaheads=lookaheads, device=args.device,
                         cache_dir=args.cache)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"schema_version": SCHEMA_VERSION,
                           "benchmark": "bench_sweep",
                           "sweep": {"budgets": list(budgets),
                                     "lookaheads": list(lookaheads)},
                           "rows": rows}, f, indent=2)
            print(f"wrote {args.json}")
        return 0
    streaming_case = None
    if args.streaming or args.tiny:
        streaming_case = TINY_STREAMING_CASE if args.tiny else STREAMING_CASE
    rows = run_bench(cases=cases, budget_frac=args.budget_frac,
                     check=not args.no_check and not args.tiny,
                     streaming_case=streaming_case, device=args.device,
                     cache_dir=args.cache)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"schema_version": SCHEMA_VERSION, "rows": rows},
                      f, indent=2)
        print(f"wrote {args.json}")
    return 0


# ---------------------------------------------------------------------------
# agg: secure aggregation; serve / submit: the plan-cache daemon
# ---------------------------------------------------------------------------


def _parse_drop(items) -> list[tuple[int, int]]:
    """``--drop R:c1,c2`` -> [(R, c1), (R, c2)] straggler pairs."""
    out: list[tuple[int, int]] = []
    for item in items or ():
        rnd, sep, rest = item.partition(":")
        if not sep or not rnd.isdigit():
            raise SystemExit(f"error: bad --drop entry {item!r} "
                             f"(want ROUND:client,client,...)")
        for c in rest.split(","):
            if not c.isdigit():
                raise SystemExit(f"error: bad --drop client {c!r} in "
                                 f"{item!r}")
            out.append((int(rnd), int(c)))
    return out


def cmd_agg(args) -> int:
    """Secure aggregation: N input-only clients -> a small compute fleet."""
    from .aggregate import AggSpec, run_aggregation, verify_aggregates
    spec = AggSpec(clients=args.clients, vec_len=args.vec_len,
                   rounds=args.rounds, servers=args.servers,
                   gateways=args.gateways, seed=args.seed,
                   max_inflight_msgs=args.max_inflight_msgs,
                   max_inflight_bytes=args.max_inflight_bytes,
                   round_timeout_s=args.round_timeout)
    transport = args.transport
    if args.rank is not None:
        if not args.peers:
            raise SystemExit("error: --rank needs --peers host:port,... "
                             "(one address per fabric rank: servers then "
                             "gateways)")
        transport = transport or "tcp"
        fabric = FabricSpec(rank=args.rank,
                            peers=tuple(args.peers.split(",")),
                            latency_s=args.latency,
                            bandwidth=args.bandwidth)
    else:
        transport = transport or "inproc"
        fabric = FabricSpec(latency_s=args.latency,
                            bandwidth=args.bandwidth)
    cache = None
    if args.cache:
        from .serve_daemon.cache import ArtifactCache
        cache = ArtifactCache(args.cache)
    res = run_aggregation(spec, transport=transport, fabric_spec=fabric,
                          cache=cache, drop=_parse_drop(args.drop),
                          device=args.device)
    for r in res.rounds:
        head = ", ".join(str(int(v)) for v in r.total[:4])
        note = (f" DEGRADED ({spec.clients - len(r.survivors)} dropped)"
                if r.degraded else "")
        print(f"round {r.rnd}: {len(r.survivors)}/{spec.clients} clients, "
              f"aggregate [{head}{', ...' if len(r.total) > 4 else ''}]"
              f"{note}")
    if res.rounds:
        print(f"{res.clients_per_s:.0f} clients/s over {res.seconds:.3f}s "
              f"on {res.device}; plan events: {res.plan_events}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"schema_version": SCHEMA_VERSION, **res.to_doc()}, f)
        print(f"wrote {args.json}")
    if args.check and res.rounds:
        try:
            verify_aggregates(res)
        except AssertionError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print("aggregate check OK")
    return 0


def cmd_serve(args) -> int:
    from .serve_daemon.server import ServeDaemon
    d = ServeDaemon(args.cache, socket_path=args.socket,
                    host=args.host, port=args.port,
                    frame_pool=args.frame_pool,
                    memory_bytes=args.memory_bytes,
                    cache_bytes=args.cache_bytes,
                    max_queue=args.max_queue, device=args.device)
    addr = d.address if isinstance(d.address, str) \
        else f"{d.address[0]}:{d.address[1]}"
    print(f"serving on {addr} (cache: {d.cache.root}, "
          f"frame pool: {d.admission.frame_pool}, device: {d.device})",
          flush=True)
    try:
        d.serve_forever()
    except KeyboardInterrupt:
        d.shutdown()
    return 0


def cmd_submit(args) -> int:
    from .serve_daemon.client import ServeError, serve_client
    with serve_client(args.connect, timeout=args.timeout) as c:
        if args.status:
            resp = c.status()
        elif args.shutdown:
            resp = c.shutdown()
        else:
            spec = _spec_from_args(args, default_mode="streaming")
            try:
                resp = c.submit(spec, execute=args.execute,
                                check=args.check,
                                queue=not args.no_queue,
                                timeout=args.timeout,
                                use_cache=not args.no_cache)
            except ServeError as e:
                print(f"error: {e}", file=sys.stderr)
                return 3 if e.rejected else 1
    text = json.dumps(resp, indent=2)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    return 0


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------


def _add_spec_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--workload", default="merge", choices=all_names())
    p.add_argument("-n", type=int, default=None,
                   help="records per party (default: the workload's)")
    p.add_argument("--budget", type=_parse_budget, default=None,
                   help="frames (int) or working-set fraction (float); "
                   "omit for unbounded")
    p.add_argument("--prefetch", type=int, default=0)
    p.add_argument("--lookahead", type=int, default=10_000)
    p.add_argument("--mode", default=None,
                   choices=("memory", "streaming", "unbounded"),
                   help="plan mode (default with --budget: streaming for "
                   "plan, memory for exec; unbounded without)")
    p.add_argument("--policy", default="min",
                   choices=("min", "min_clean", "lru", "fifo"),
                   help="eviction policy")
    p.add_argument("--swap-bypass", action="store_true",
                   help="serve a read from its page's pending write")
    p.add_argument("--exec-backend", dest="exec_backend", default="batched",
                   choices=("scalar", "batched", "overlap"),
                   help="engine loop: a batch schedule, one instruction at "
                   "a time, or an overlap schedule (NET sends hoisted, "
                   "receives completed where needed); outputs are "
                   "identical")
    p.add_argument("--workers", type=int, default=1,
                   help="engines per party (NET_* directives between them)")
    p.add_argument("--parallel", default="serial",
                   choices=("serial", "thread", "process"),
                   help="how the workers' programs are planned")
    p.add_argument("--storage", default="ram", choices=("ram", "memmap"),
                   help="swap storage: pinned host pages or a swap file")
    p.add_argument("--ckks-ring", type=int, default=None,
                   help="CKKS ring dimension N (default: the workload's)")
    p.add_argument("--ckks-levels", type=int, default=None,
                   help="CKKS multiplicative depth (default: the workload's)")


def _add_cache_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cache", metavar="DIR", default=None,
                   help="artifact-cache root: reuse traced programs, plans "
                   "and schedules across invocations")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (plain PyTorch versions)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="trace and plan a job; save it to a "
                       "directory")
    _add_spec_args(p)
    _add_cache_arg(p)
    _add_device_arg(p)
    p.add_argument("--out", required=True, help="output directory")
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("run", help="execute a saved plan (all ranks, or "
                       "one with --worker)")
    p.add_argument("jobdir")
    p.add_argument("--check", action="store_true",
                   help="compare outputs with the workload's oracle")
    p.add_argument("--real", action="store_true",
                   help="real two-party garbled circuits (default: the "
                   "manifest's driver; CKKS needs no flag)")
    p.add_argument("--storage", default=None, choices=("ram", "memmap"))
    p.add_argument("--driver", default=None,
                   choices=DRIVER_CHOICES)
    p.add_argument("--worker", type=int, default=None, metavar="K",
                   help="distributed mode: run only global rank K "
                   "(party * workers + worker) against --peers")
    p.add_argument("--peers", default=None,
                   help="comma list of host:port, one per global rank")
    p.add_argument("--transport", default=None,
                   choices=("inproc", "tcp", "shaped", "shaped+tcp"),
                   help="transport backend (default: inproc; --worker "
                   "defaults to tcp)")
    p.add_argument("--latency", type=float, default=0.0,
                   help="shaped: per-link one-way latency (s)")
    p.add_argument("--bandwidth", type=float, default=None,
                   help="shaped: per-link bandwidth (bytes/s)")
    p.add_argument("--exec-backend", dest="exec_backend", default=None,
                   choices=("scalar", "batched", "overlap"),
                   help="override the manifest's engine loop; outputs are "
                   "identical")
    p.add_argument("--digest", action="store_true",
                   help="hash each hosted garbler's table stream")
    p.add_argument("--json", default=None,
                   help="write this process's outputs and report here")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("fabric", help="run a saved plan as a localhost TCP "
                       "fleet, one process a rank")
    p.add_argument("jobdir")
    p.add_argument("--check", action="store_true",
                   help="compare the merged outputs with the oracle")
    p.add_argument("--real", action="store_true",
                   help="real two-party garbled circuits (2x the ranks)")
    p.add_argument("--storage", default=None, choices=("ram", "memmap"))
    p.add_argument("--driver", default=None,
                   choices=DRIVER_CHOICES)
    p.add_argument("--digest", action="store_true",
                   help="each garbler rank hashes its table stream")
    p.add_argument("--json", default=None,
                   help="write the merged outputs and every rank's report")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds the fleet may take; then it is killed")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_fabric)

    p = sub.add_parser("exec", help="trace, plan and execute in one process")
    _add_spec_args(p)
    p.add_argument("--real", action="store_true",
                   help="real two-party garbled circuits (default: the "
                   "plaintext oracle; CKKS needs no flag)")
    p.add_argument("--check", action="store_true",
                   help="compare outputs with the workload's oracle")
    _add_cache_arg(p)
    _add_device_arg(p)
    p.add_argument("--json", default=None, help="also write the summary here")
    p.set_defaults(fn=cmd_exec)

    p = sub.add_parser("bench", help="drive the §8.2 scenarios through the "
                       "timing simulator (model seconds)")
    p.add_argument("--cases", default=None,
                   help="comma list of workload=n (default: the Fig. 8 "
                   "cases)")
    p.add_argument("--budget-frac", type=float, default=0.4)
    p.add_argument("--tiny", action="store_true",
                   help="small sizes, no claim assertions")
    p.add_argument("--streaming", action="store_true",
                   help="add a past-planner-cap case via the file pipeline")
    p.add_argument("--sweep", action="store_true",
                   help="budget x lookahead grid instead of the fixed "
                   "scenario run (rows carry both knob values)")
    p.add_argument("--budgets", default=None,
                   help="comma list of budget fractions for --sweep")
    p.add_argument("--lookaheads", default=None,
                   help="comma list of planner lookaheads for --sweep")
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--json", metavar="PATH",
                   help="write the rows as JSON")
    _add_cache_arg(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("agg", help="secure aggregation: many input-only "
                       "clients stream additive shares to a compute fleet")
    p.add_argument("--clients", type=int, required=True,
                   help="number of simulated input-only clients")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--vec-len", type=int, default=64,
                   help="per-client uint64 vector length")
    p.add_argument("--servers", type=int, default=2,
                   help="compute-fleet size (fabric ranks [0, S))")
    p.add_argument("--gateways", type=int, default=2,
                   help="client-side fabric endpoints (ranks [S, S+G))")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--transport", default=None,
                   choices=("inproc", "tcp", "shaped", "shaped+tcp"),
                   help="transport backend (default: inproc; --rank "
                   "defaults to tcp)")
    p.add_argument("--rank", type=int, default=None, metavar="K",
                   help="distributed mode: host ONLY fabric rank K against "
                   "--peers")
    p.add_argument("--peers", default=None,
                   help="comma list of host:port, one per fabric rank")
    p.add_argument("--latency", type=float, default=0.0,
                   help="shaped: per-link one-way latency (s)")
    p.add_argument("--bandwidth", type=float, default=None,
                   help="shaped: per-link bandwidth (bytes/s)")
    p.add_argument("--max-inflight-msgs", type=int, default=0,
                   help="per-link reorder-buffer message bound (0 = off)")
    p.add_argument("--max-inflight-bytes", type=int, default=1 << 20,
                   help="per-link reorder-buffer byte bound (backpressure)")
    p.add_argument("--round-timeout", type=float, default=30.0,
                   help="straggler timeout per round (s); late clients "
                   "degrade the round to the surviving subset")
    p.add_argument("--drop", action="append", metavar="R:c1,c2",
                   help="simulate stragglers: these clients never send in "
                   "round R (repeatable)")
    _add_cache_arg(p)
    p.add_argument("--check", action="store_true",
                   help="verify every revealed aggregate against the "
                   "oracle over its surviving subset")
    p.add_argument("--json", metavar="PATH",
                   help="write the full result envelope as JSON")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_agg)

    p = sub.add_parser("serve", help="run the multi-tenant plan-cache "
                       "daemon")
    p.add_argument("--cache", required=True, metavar="DIR",
                   help="artifact-cache root the daemon owns")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="unix socket path to listen on (default: TCP)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=None,
                   help="TCP port (default: OS-assigned, printed on start)")
    p.add_argument("--frame-pool", type=int, default=1 << 16,
                   help="shared frame budget across concurrent jobs")
    p.add_argument("--memory-bytes", type=int, default=None,
                   help="optional cap on summed per-job memory estimates")
    p.add_argument("--cache-bytes", type=int, default=None,
                   help="LRU-evict cache entries beyond this many bytes")
    p.add_argument("--max-queue", type=int, default=64,
                   help="max jobs waiting for admission before rejecting")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("submit", help="submit a job to a serve daemon")
    p.add_argument("--connect", required=True, metavar="ADDR",
                   help="daemon address: unix socket path or host:port")
    _add_spec_args(p)
    p.add_argument("--execute", action="store_true",
                   help="also execute the planned job on the daemon")
    p.add_argument("--check", action="store_true",
                   help="with --execute: verify against the oracle")
    p.add_argument("--no-queue", action="store_true",
                   help="reject (exit 3) instead of waiting for admission")
    p.add_argument("--no-cache", action="store_true",
                   help="bypass the daemon's artifact cache (cold run)")
    p.add_argument("--timeout", type=float, default=None,
                   help="admission + socket timeout (s)")
    p.add_argument("--status", action="store_true",
                   help="just print the daemon's status JSON")
    p.add_argument("--shutdown", action="store_true",
                   help="ask the daemon to shut down")
    p.add_argument("--json", metavar="PATH",
                   help="also write the response JSON here")
    p.set_defaults(fn=cmd_submit)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except SpecMismatchError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)
    except (ValueError, KeyError, TransportError) as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    sys.exit(main())
