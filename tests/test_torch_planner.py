"""The port's traces, plans, batch schedules and overlap schedules against
the JAX package's, for every worker of one- and multi-worker jobs, and the
reference planner's own memory programs run through the port's engine.
Records and schedule arrays are compared bitwise."""

import dataclasses

import numpy as np
import pytest

from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core.bytecode import encode_chunk as ref_encode
from repro.exec.batching import build_batch_schedule as ref_batch_schedule
from repro.exec.overlap import build_overlap_schedule as ref_overlap_schedule
from repro_torch.api import JobSpec, Session
from repro_torch.core.bytecode import decode_chunk, encode_chunk
from repro_torch.exec.batching import build_batch_schedule
from repro_torch.exec.overlap import build_overlap_schedule
from repro_torch.interop import program_from_records

#: (n, budget, prefetch, lookahead): a working-set fraction and a frame count
CASES = [(256, 0.4, 8, 10_000), (512, 12, 2, 40)]
#: the other workloads at the paper's sizes (Fig. 8; passreuse and pir
#: Fig. 12/13; sort at n = 1024, whose plan at Fig. 8's 16384 the chip does
#: not run) at a working-set fraction, and at their test sizes, as
#: (workload, n, budget, prefetch, lookahead)
WORKLOAD_CASES = [
    ("ljoin", 256, 0.4, 64, 10_000), ("mvmul", 384, 0.4, 64, 10_000),
    ("binfclayer", 2048, 0.4, 64, 10_000), ("sort", 1024, 0.4, 64, 10_000),
    ("passreuse", 2048, 0.4, 64, 10_000), ("pir", 256, 0.4, 8, 10_000),
    ("ljoin", 16, 5, 1, 10_000), ("mvmul", 32, 4, 1, 10_000),
    ("binfclayer", 128, 4, 1, 10_000), ("sort", 64, 5, 1, 10_000),
    ("passreuse", 64, 5, 1, 10_000), ("pir", 64, 4, 1, 10_000)]
#: multi-worker jobs (the JAX package's multi-worker test sizes and the
#: apps), each worker planned at frames that make it swap where its
#: working set allows, and merge at Fig. 10's tiny size, fraction and
#: prefetch (benchmarks/fig10_parallel.py:29-31), as
#: (workload, n, budget, prefetch, lookahead, workers)
WORKER_CASES = [
    ("merge", 256, 6, 1, 10_000, 2), ("merge", 256, 5, 1, 10_000, 4),
    ("merge", 2048, 0.4, 16, 10_000, 4), ("sort", 256, 5, 1, 10_000, 4),
    ("ljoin", 32, 8, 1, 10_000, 2), ("mvmul", 32, 4, 1, 10_000, 2),
    ("binfclayer", 128, 4, 1, 10_000, 2), ("rsum", 32, 3, 1, 10_000, 4),
    ("rstats", 16, 4, 1, 10_000, 2), ("rmvmul", 4, 3, 1, 10_000, 2),
    ("t_rmatmul", 4, 4, 1, 10_000, 2), ("n_rmatmul", 2, 3, 1, 10_000, 2),
    ("pir", 16, 4, 1, 10_000, 2)]
ALL_CASES = [pytest.param("merge", *c, 1, id="-".join(map(str, c)))
             for c in CASES] + [pytest.param(*c, 1, id="-".join(map(str, c)))
                                for c in WORKLOAD_CASES] + \
    [pytest.param(*c, id="-".join(map(str, c[:5])) + f"-p{c[5]}")
     for c in WORKER_CASES]


def _sessions(n, budget, prefetch, lookahead, wl="merge", workers=1):
    ref = RefSession(RefJobSpec(workload=wl, n=n, memory_budget=budget,
                                lookahead=lookahead, prefetch_pages=prefetch,
                                num_workers=workers, plan_core="scalar"))
    port = Session(JobSpec(wl, n=n, memory_budget=budget,
                           lookahead=lookahead, prefetch_pages=prefetch,
                           num_workers=workers), device="cpu")
    return ref, port


def _header(p) -> dict:
    return {k: getattr(p, k) for k in ("page_shift", "phase", "num_frames",
                                        "prefetch_slots", "vspace_slots",
                                        "meta")}


@pytest.mark.parametrize("wl,n,budget,prefetch,lookahead,workers",
                         ALL_CASES)
def test_trace_plan_schedule_match_reference(wl, n, budget, prefetch,
                                             lookahead, workers):
    """Per worker: the trace, the working set, the plan config and memory
    program, the plan reports, the batch schedule and the overlap
    schedule."""
    ref, port = _sessions(n, budget, prefetch, lookahead, wl, workers)
    assert len(port.trace()) == len(ref.trace()) == workers
    assert len(port.plan()) == len(ref.plan()) == workers
    for w in range(workers):
        rv, pv = ref.trace()[w], port.trace()[w]
        assert (pv.worker, pv.num_workers) == (rv.worker, rv.num_workers)
        assert np.array_equal(encode_chunk(pv.instrs),
                              ref_encode(rv.instrs))
        assert pv.vspace_slots == rv.vspace_slots
        assert port.working_set(w) == ref.working_set(w)

        rm, pm = ref.plan()[w], port.plan()[w]
        rcfg, pcfg = ref._cfgs[w], port.configs[w]
        assert (pcfg.num_frames, pcfg.prefetch_pages, pcfg.lookahead) == \
            (rcfg.num_frames, rcfg.prefetch_pages, rcfg.lookahead)
        assert np.array_equal(encode_chunk(pm.instrs), ref_encode(rm.instrs))
        for k in ("phase", "num_frames", "prefetch_slots", "vspace_slots",
                  "worker", "num_workers"):
            assert getattr(pm, k) == getattr(rm, k), k
        rrep, prep = ref.plan_reports[w], port.plan_reports[w]
        assert dataclasses.asdict(prep.replacement) == \
            dataclasses.asdict(rrep.replacement)
        assert dataclasses.asdict(prep.schedule) == \
            dataclasses.asdict(rrep.schedule)
        if wl == "merge":
            assert prep.replacement.swap_ins > 0

        rs, ps = ref_batch_schedule(rm), build_batch_schedule(pm)
        assert (ps.chunk_instrs, ps.n_records) == \
            (rs.chunk_instrs, rs.n_records)
        for f in ("order", "bounds", "group_op", "chunk_groups"):
            assert np.array_equal(getattr(ps, f), getattr(rs, f)), f
        ro, po = ref_overlap_schedule(rm), build_overlap_schedule(pm)
        assert (po.chunk_instrs, po.n_records) == \
            (ro.chunk_instrs, ro.n_records)
        for f in ("order", "bounds", "group_kind", "group_op",
                  "chunk_groups"):
            assert np.array_equal(getattr(po, f), getattr(ro, f)), f
        assert po.stats() == ro.stats()


def test_record_codec_round_trip():
    _, port = _sessions(*CASES[1])
    prog = port.plan()[0]
    rec = encode_chunk(prog.instrs)
    assert decode_chunk(rec) == prog.instrs
    same = program_from_records(rec, _header(prog))
    assert same.instrs == prog.instrs and _header(same) == _header(prog)
    with pytest.raises(ValueError):
        program_from_records(rec, {"phase": "memory"})


def test_reference_plan_runs_in_port_engine():
    """The JAX package's planned memory program, carried over as records,
    runs two-party in the port and gives the reference (oracle) outputs."""
    spec = dict(n=32, memory_budget=6, lookahead=10_000, prefetch_pages=1)
    ref = RefSession(RefJobSpec(workload="merge", **spec))
    rm = ref.plan()[0]
    prog = program_from_records(ref_encode(rm.instrs), _header(rm))
    port = Session(JobSpec("merge", **spec), device="cpu")
    assert np.array_equal(encode_chunk(port.plan()[0].instrs),
                          ref_encode(rm.instrs))
    port.adopt_plan([prog])
    out = port.execute(real=True, check=True)
    want = ref.workload.oracle(32)
    assert sorted(out) == sorted(want)
    assert all(np.array_equal(out[k], want[k]) for k in want)


def test_reference_multi_worker_plan_runs_in_port_engine():
    """The JAX package's two workers' memory programs, carried over as
    records, run two-party in the port on the overlap loop (the NET
    exchanges between the workers included) and give the oracle's
    outputs."""
    spec = dict(n=64, memory_budget=5, lookahead=10_000, prefetch_pages=1,
                num_workers=2)
    ref = RefSession(RefJobSpec(workload="merge", **spec))
    progs = [program_from_records(ref_encode(rm.instrs),
                                  dict(_header(rm), worker=rm.worker,
                                       num_workers=rm.num_workers))
             for rm in ref.plan()]
    assert [(p.worker, p.num_workers) for p in progs] == [(0, 2), (1, 2)]
    port = Session(JobSpec("merge", exec_backend="overlap", **spec),
                   device="cpu")
    port.adopt_plan(progs)
    out = port.execute(real=True, check=True)
    assert len(out) == 4
    assert all(e.swap_ins > 0 and e.net_messages > 0
               for e in port.engine_stats)
    with pytest.raises(ValueError, match="one per worker"):
        port.adopt_plan(progs[:1])
