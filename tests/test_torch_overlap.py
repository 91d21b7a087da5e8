"""The overlap backend in the port: the schedule's structure (sends hoisted,
receives posted and waited, every receive row scheduled twice), its
fallback to program order, and runs on the overlap loop bitwise equal to
the batched and the scalar loops at p = 1, 2 and 4, in the clear (outputs
and every engine's final memory), two-party (outputs, AND counts, the
table stream of each party link) and on CKKS at ring 128.  The schedules
themselves are held against the JAX package's in
``test_torch_planner.py``."""

import numpy as np
import pytest

from repro.core.bytecode import Instr as RefInstr, Op as RefOp, \
    Program as RefProgram
from repro.exec.overlap import build_overlap_schedule as ref_overlap
from repro_torch.api import JobSpec, Session
from repro_torch.core.bytecode import Instr, Op, Program, \
    iter_record_chunks, unpack_heads
from repro_torch.exec import OverlapSchedule, build_overlap_schedule
from repro_torch.exec.overlap import K_LOCAL, K_RECV_POST, K_RECV_WAIT, \
    K_SEND

from _torch_gc_jobs import same_outputs

LOOPS = ["scalar", "batched", "overlap"]


def _planned(**kw) -> tuple[Program, OverlapSchedule]:
    s = Session(JobSpec(**kw), device="cpu")
    prog = s.plan()[0]
    return prog, build_overlap_schedule(prog)


@pytest.mark.parametrize("kw", [
    dict(workload="merge", n=256, num_workers=2, memory_budget=6,
         prefetch_pages=1),
    dict(workload="merge", n=256, num_workers=2, plan_mode="unbounded"),
], ids=["planned", "unbounded"])
def test_schedule_hoists_sends_and_defers_receives(kw):
    prog, sched = _planned(**kw)
    sched.validate_for(prog)
    st = sched.stats()
    assert st["hoisted_sends"] > 0 and st["deferred_recvs"] > 0
    ci = 0
    for _, rec, _ in iter_record_chunks(prog, sched.chunk_instrs):
        ops = unpack_heads(rec[:, 0])[0]
        seen = np.zeros(len(rec), dtype=np.int64)
        posted = set()
        for g in range(sched.chunk_groups[ci], sched.chunk_groups[ci + 1]):
            kind = int(sched.group_kind[g])
            for r in sched.order[sched.bounds[g]:sched.bounds[g + 1]]:
                r = int(r)
                if kind == K_SEND:
                    assert ops[r] == int(Op.NET_SEND)
                elif kind == K_RECV_POST:
                    assert ops[r] == int(Op.NET_RECV)
                    posted.add(r)
                elif kind == K_RECV_WAIT:
                    assert r in posted, "a wait before its post"
                else:
                    assert kind == K_LOCAL
                seen[r] += 1
        recv = ops == int(Op.NET_RECV)
        assert np.all(seen[recv] == 2) and np.all(seen[~recv] == 1)
        assert len(posted) == int(recv.sum())
        ci += 1
    sched.n_records += 1
    with pytest.raises(ValueError, match="stale"):
        sched.validate_for(prog)


def _hand_program(instrs) -> tuple[Program, RefProgram]:
    """The same hand-written program in both packages."""
    kw = dict(page_shift=12, protocol="gc", phase="virtual",
              vspace_slots=64)
    ref = [RefInstr(RefOp[i.op.name], i.outs, i.ins, i.imm) for i in instrs]
    return Program(instrs=list(instrs), **kw), RefProgram(instrs=ref, **kw)


def _groups(sched) -> list:
    return [(int(k), int(o), sched.order[a:b].tolist()) for k, o, a, b in
            zip(sched.group_kind, sched.group_op, sched.bounds[:-1],
                sched.bounds[1:])]


def test_schedule_fills_the_receive_gap_with_independent_work():
    """A receive is posted first, independent work runs before its wait,
    and the send that reads the received value goes out after it."""
    prog, ref = _hand_program([
        Instr(Op.NET_RECV, outs=((0, 4),), imm=(1, 1)),
        Instr(Op.COPY, outs=((8, 4),), ins=((0, 4),)),
        Instr(Op.NET_SEND, ins=((8, 4),), imm=(1, 2)),
        Instr(Op.COPY, outs=((16, 4),), ins=((20, 4),))])
    sched = build_overlap_schedule(prog)
    assert _groups(sched) == [(K_RECV_POST, -1, [0]), (K_LOCAL, -1, [3]),
                              (K_RECV_WAIT, -1, [0]), (K_LOCAL, -1, [1]),
                              (K_SEND, -1, [2])]
    assert _groups(sched) == _groups(ref_overlap(ref))


def test_window_with_overlapping_spans_falls_back_to_program_order():
    """Spans that are neither identical nor disjoint (here a COPY that
    reads half of a received value) make the window run in program
    order, as in the JAX package."""
    prog, ref = _hand_program([
        Instr(Op.NET_RECV, outs=((0, 4),), imm=(1, 1)),
        Instr(Op.COPY, outs=((8, 4),), ins=((2, 4),)),
        Instr(Op.NET_SEND, ins=((8, 4),), imm=(1, 2))])
    sched = build_overlap_schedule(prog)
    assert _groups(sched) == [(K_LOCAL, -1, [0, 1, 2])]
    assert _groups(sched) == _groups(ref_overlap(ref))


def _memories(s) -> list[np.ndarray]:
    return [e.memory.numpy().copy() for e in s.engines]


@pytest.mark.parametrize("p", [1, 2, 4])
def test_clear_merge_equal_on_every_loop(p):
    """Outputs and every engine's final memory, planned so that every
    worker swaps."""
    kw = dict(workload="merge", n=256, num_workers=p, memory_budget=6,
              prefetch_pages=1)
    outs, mems = {}, {}
    for loop in LOOPS:
        s = Session(JobSpec(exec_backend=loop, **kw), device="cpu")
        outs[loop] = s.execute(real=False, check=True)
        mems[loop] = _memories(s)
    for loop in ("batched", "overlap"):
        assert same_outputs(outs[loop], outs["scalar"])
        assert all(np.array_equal(a, b)
                   for a, b in zip(mems[loop], mems["scalar"]))
    st = s.engine_stats
    assert all(e.swap_ins > 0 for e in st)
    assert (sum(e.posted_recvs for e in st) > 0) == (p > 1)


def test_unbounded_overlap_posts_the_whole_exchange_window():
    """With no swap barrier every receive of an exchange pass is posted
    before any wait (the JAX package's test_overlap.py)."""
    kw = dict(workload="merge", n=256, num_workers=2, plan_mode="unbounded")
    scalar = Session(JobSpec(exec_backend="scalar", **kw), device="cpu")
    overlap = Session(JobSpec(exec_backend="overlap", **kw), device="cpu")
    assert same_outputs(overlap.execute(real=False, check=True),
                        scalar.execute(real=False, check=True))
    st = overlap.engine_stats
    assert sum(e.posted_recvs for e in st) > 0
    assert max(e.max_inflight_recvs for e in st) >= 4
    assert [e.net_messages for e in st] == \
        [e.net_messages for e in scalar.engine_stats]


@pytest.mark.parametrize("wl,n,p,frames", [
    ("rmvmul", 4, 1, 3), ("rstats", 16, 2, 4), ("rsum", 32, 4, 3)])
def test_ckks_equal_on_every_loop(wl, n, p, frames):
    kw = dict(workload=wl, n=n, num_workers=p, memory_budget=frames,
              prefetch_pages=1)
    outs, mems = {}, {}
    for loop in LOOPS:
        s = Session(JobSpec(exec_backend=loop, **kw), device="cpu")
        outs[loop] = s.execute(check=True)
        mems[loop] = _memories(s)
        if loop == "overlap":
            assert (s.engine_stats[0].posted_recvs > 0) == (p > 1)
    for loop in ("batched", "overlap"):
        assert same_outputs(outs[loop], outs["scalar"])
        assert all(np.array_equal(a, b)
                   for a, b in zip(mems[loop], mems["scalar"]))


@pytest.mark.parametrize("n,p", [(32, 1), (64, 4)])
def test_two_party_merge_equal_on_every_loop(n, p):
    """Outputs and AND counts on every loop; the table stream of each
    party link on the overlap loop equals the batched loop's (the same AND
    calls; the scalar loop's gate ids follow its own order)."""
    kw = dict(workload="merge", n=n, num_workers=p, memory_budget=5,
              prefetch_pages=1)
    outs, ands, digests = {}, {}, {}
    for loop in LOOPS:
        s = Session(JobSpec(exec_backend=loop, **kw), device="cpu")
        outs[loop] = s.execute(real=True, check=True, digest=True)
        ands[loop] = [g.ands for g in s.gate_counts]
        digests[loop] = s.table_digests
        assert sorted(s.table_digests) == [(k, p + k) for k in range(p)]
    for loop in ("batched", "overlap"):
        assert same_outputs(outs[loop], outs["scalar"])
        assert ands[loop] == ands["scalar"]
    assert digests["overlap"] == digests["batched"]
