"""The port's trace, plan and batch schedule against the JAX package's, and
the reference planner's own memory program run through the port's engine.
Records are compared bitwise."""

import dataclasses

import numpy as np
import pytest

from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core.bytecode import encode_chunk as ref_encode
from repro.exec.batching import build_batch_schedule as ref_batch_schedule
from repro_torch.api import JobSpec, Session
from repro_torch.core.bytecode import decode_chunk, encode_chunk
from repro_torch.exec.batching import build_batch_schedule
from repro_torch.interop import program_from_records

#: (n, budget, prefetch, lookahead): a working-set fraction and a frame count
CASES = [(256, 0.4, 8, 10_000), (512, 12, 2, 40)]


def _sessions(n, budget, prefetch, lookahead):
    ref = RefSession(RefJobSpec(workload="merge", n=n, memory_budget=budget,
                                lookahead=lookahead, prefetch_pages=prefetch,
                                plan_core="scalar"))
    port = Session(JobSpec("merge", n=n, memory_budget=budget,
                           lookahead=lookahead, prefetch_pages=prefetch),
                   device="cpu")
    return ref, port


def _header(p) -> dict:
    return {k: getattr(p, k) for k in ("page_shift", "phase", "num_frames",
                                        "prefetch_slots", "vspace_slots",
                                        "meta")}


@pytest.mark.parametrize("n,budget,prefetch,lookahead", CASES)
def test_trace_plan_schedule_match_reference(n, budget, prefetch, lookahead):
    ref, port = _sessions(n, budget, prefetch, lookahead)
    rv, pv = ref.trace()[0], port.trace()[0]
    assert np.array_equal(encode_chunk(pv.instrs), ref_encode(rv.instrs))
    assert pv.vspace_slots == rv.vspace_slots
    assert port.working_set() == ref.working_set(0)

    rm, pm = ref.plan()[0], port.plan()[0]
    rcfg = ref._cfgs[0]
    assert (port.config.num_frames, port.config.prefetch_pages,
            port.config.lookahead) == (rcfg.num_frames, rcfg.prefetch_pages,
                                       rcfg.lookahead)
    assert np.array_equal(encode_chunk(pm.instrs), ref_encode(rm.instrs))
    for k in ("phase", "num_frames", "prefetch_slots", "vspace_slots"):
        assert getattr(pm, k) == getattr(rm, k), k
    rrep, prep = ref.plan_reports[0], port.plan_reports[0]
    assert dataclasses.asdict(prep.replacement) == \
        dataclasses.asdict(rrep.replacement)
    assert dataclasses.asdict(prep.schedule) == \
        dataclasses.asdict(rrep.schedule)
    assert prep.replacement.swap_ins > 0

    rs, ps = ref_batch_schedule(rm), build_batch_schedule(pm)
    assert (ps.chunk_instrs, ps.n_records) == (rs.chunk_instrs, rs.n_records)
    for f in ("order", "bounds", "group_op", "chunk_groups"):
        assert np.array_equal(getattr(ps, f), getattr(rs, f)), f


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
