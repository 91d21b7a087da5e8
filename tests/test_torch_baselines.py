"""The baselines and knobs the paper measures against, in the port and in
the JAX package, on the CPU: plans under every eviction policy with and
without swap bypass, unbounded (virtual-phase) sessions, the scalar engine
loop, the swap file (``storage="memmap"``), the JobSpec's validation and
the CLI's flags.  Every comparison is exact: plan records bitwise, GC
outputs, AND counts and garbled-table traffic equal, CKKS outputs bitwise.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core.bytecode import encode_chunk as ref_encode
from repro.exec.batching import build_batch_schedule as ref_batch_schedule
from repro_torch import __main__ as cli
from repro_torch.api import JobSpec, Session
from repro_torch.core.bytecode import Instr, Op, encode_chunk
from repro_torch.core.replacement import POLICIES, plan_replacement
from repro_torch.core.storage import FileSwapIO, MemmapStorage
from repro_torch.exec.batching import build_batch_schedule
from repro_torch.protocols.ckks.driver import CkksDriver

TAB = 1          # the garbled-table tag of the party channel, in both packages
GC_SMALL = dict(n=64, memory_budget=5, lookahead=10_000, prefetch_pages=1)
CKKS_SMALL = dict(n=4, memory_budget=3, prefetch_pages=1)


def _tables(stats) -> tuple[int, int]:
    msgs = sum(v.messages for k, v in stats.items() if k[2] == TAB)
    return msgs, sum(v.bytes for k, v in stats.items() if k[2] == TAB)


def _same_outputs(out: dict, want: dict) -> bool:
    return sorted(out) == sorted(want) and \
        all(np.array_equal(out[k], want[k]) for k in want)


def _swaps(s) -> list[tuple[int, int, int, int]]:
    return [(e.swap_ins, e.swap_outs, e.io_read_bytes, e.io_write_bytes)
            for e in s.engine_stats]


# ---------------------------------------------------------------------------
# plans: every policy, with and without swap bypass
# ---------------------------------------------------------------------------

#: (workload, n, budget, prefetch): GC at a working-set fraction, CKKS
#: (ring 128) at frame counts that swap
PLAN_JOBS = [("merge", 256, 0.4, 8), ("merge", 512, 0.4, 8),
             ("rmvmul", 4, 3, 1), ("rstats", 8, 4, 1)]


@pytest.mark.parametrize("swap_bypass", [False, True],
                         ids=["plain", "bypass"])
@pytest.mark.parametrize("policy", ["min", "min_clean", "lru", "fifo"])
@pytest.mark.parametrize("wl,n,budget,prefetch", PLAN_JOBS,
                         ids=[f"{j[0]}{j[1]}" for j in PLAN_JOBS])
def test_plan_matches_reference(wl, n, budget, prefetch, policy,
                                swap_bypass):
    job = dict(n=n, memory_budget=budget, prefetch_pages=prefetch,
               policy=policy, swap_bypass=swap_bypass)
    ref = RefSession(RefJobSpec(workload=wl, plan_core="scalar", **job))
    port = Session(JobSpec(wl, **job), device="cpu")
    rm, pm = ref.plan()[0], port.plan()[0]
    assert np.array_equal(encode_chunk(pm.instrs), ref_encode(rm.instrs))
    for k in ("phase", "num_frames", "prefetch_slots", "vspace_slots"):
        assert getattr(pm, k) == getattr(rm, k), k
    rrep, prep = ref.plan_reports[0], port.plan_reports[0]
    assert dataclasses.asdict(prep.replacement) == \
        dataclasses.asdict(rrep.replacement)
    assert dataclasses.asdict(prep.schedule) == \
        dataclasses.asdict(rrep.schedule)
    assert prep.replacement.policy == policy
    assert prep.replacement.swap_ins > 0
    assert (pm.meta["plan"]["policy"], pm.meta["plan"]["swap_bypass"]) == \
        (policy, swap_bypass)


#: the JAX package's scalar-core plans of the main jobs' shapes: (frames,
#: swap-ins, swap-outs, prefetched, bypass hits)
MERGE_1024 = dict(workload="merge", n=1024, memory_budget=0.4)
RMVMUL_MAIN = dict(workload="rmvmul", n=24, memory_budget=0.4, ckks_ring=1024,
                   ckks_levels=2)
POLICY_TABLE = [
    (MERGE_1024, "min", False, 4, (26, 363, 363, 363, 0)),
    (MERGE_1024, "min", True, 4, (26, 363, 363, 358, 5)),
    (MERGE_1024, "min_clean", False, 4, (26, 363, 363, 363, 0)),
    (MERGE_1024, "lru", False, 4, (26, 533, 533, 533, 0)),
    (MERGE_1024, "fifo", False, 4, (26, 533, 533, 533, 0)),
    (MERGE_1024, "lru", False, 0, (26, 531, 531, 0, 0)),
    (RMVMUL_MAIN, "min", False, 8, (16, 646, 309, 646, 0)),
    (RMVMUL_MAIN, "min", True, 8, (16, 646, 309, 640, 6)),
    (RMVMUL_MAIN, "min_clean", False, 8, (16, 646, 309, 646, 0)),
    (RMVMUL_MAIN, "lru", False, 8, (16, 908, 390, 908, 0)),
    (RMVMUL_MAIN, "fifo", False, 8, (16, 1004, 486, 1004, 0)),
    (RMVMUL_MAIN, "lru", False, 0, (16, 861, 365, 0, 0)),
]


@pytest.mark.parametrize("job,policy,bypass,prefetch,want", POLICY_TABLE,
                         ids=[f"{j['workload']}-{p}-{'b' if b else 'p'}{f}"
                              for j, p, b, f, _ in POLICY_TABLE])
def test_policy_swap_counts(job, policy, bypass, prefetch, want):
    """The swap counts chip_smoke.py's baselines phase asserts on the card."""
    s = Session(JobSpec(**job, policy=policy, swap_bypass=bypass,
                        prefetch_pages=prefetch), device="cpu")
    s.plan()
    r = s.plan_reports[0]
    assert (s.config.num_frames, r.replacement.swap_ins,
            r.replacement.swap_outs, r.schedule.prefetched,
            r.schedule.bypass_hits) == want


def test_unknown_policy_raises():
    assert sorted(POLICIES) == ["fifo", "lru", "min", "min_clean"]
    prog = Session(JobSpec("merge", n=64, memory_budget=5),
                   device="cpu").trace()[0]
    with pytest.raises(ValueError, match="policy"):
        plan_replacement(prog, 5, policy="opt")


# ---------------------------------------------------------------------------
# batch schedules of virtual programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wl,n", [("merge", 256), ("rmvmul", 4)])
def test_virtual_batch_schedule_matches_reference(wl, n):
    ref = RefSession(RefJobSpec(workload=wl, n=n, plan_mode="unbounded"))
    port = Session(JobSpec(wl, n=n, plan_mode="unbounded"), device="cpu")
    rv, pv = ref.plan()[0], port.plan()[0]
    assert pv.phase == rv.phase == "virtual"
    assert np.array_equal(encode_chunk(pv.instrs), ref_encode(rv.instrs))
    rs, ps = ref_batch_schedule(rv), build_batch_schedule(pv)
    ps.validate_for(pv)
    for f in ("order", "bounds", "group_op", "chunk_groups"):
        assert np.array_equal(getattr(ps, f), getattr(rs, f)), f
    # FREE rows are hoisted out of their windows into scalar groups
    frees = {i for i, ins in enumerate(pv.instrs) if ins.op == Op.FREE}
    assert frees
    for g in np.flatnonzero(ps.group_op >= 0):
        rows = ps.order[ps.bounds[g]:ps.bounds[g + 1]]
        assert not frees & set(rows.tolist())


# ---------------------------------------------------------------------------
# unbounded sessions and the scalar loop against the reference
# ---------------------------------------------------------------------------

def _check_unbounded(s: Session) -> None:
    prog = s.plan()[0]
    assert prog.phase == "virtual" and s.config is None
    assert s.plan_reports[0].replacement is None
    for eng in s.engines:
        st = eng.stats
        assert (st.swap_ins, st.swap_outs, st.directives, st.io_read_bytes,
                st.io_write_bytes) == (0, 0, 0, 0, 0)
        assert eng.memory.shape[0] == prog.vspace_slots
        assert eng.pf is None and eng.io is None
        assert st.frame_bytes == eng.memory.numel() * 8


@pytest.mark.parametrize("backend", ["batched", "scalar"])
def test_unbounded_gc_matches_reference(backend):
    job = dict(n=64, plan_mode="unbounded", exec_backend=backend)
    ref = RefSession(RefJobSpec(workload="merge", driver="gc-2party", **job))
    ref_out = ref.execute(check=True)
    ref_msgs, ref_bytes = _tables(ref.transport_stats)
    s = Session(JobSpec("merge", **job), device="cpu")
    out = s.execute(real=True, check=True)
    assert _same_outputs(out, ref_out)
    g, e = s.gate_counts
    assert g.ands == e.ands == ref_bytes // 32
    assert _tables(s.transport_stats) == (ref_msgs, ref_bytes)
    _check_unbounded(s)
    batched = [st.batches for st in s.engine_stats]
    assert all(batched) if backend == "batched" else not any(batched)
    assert ("batch_schedule_s" in s.timings) == (backend == "batched")


def test_scalar_gc_matches_reference():
    ref = RefSession(RefJobSpec(workload="merge", driver="gc-2party",
                                exec_backend="scalar", **GC_SMALL))
    ref_out = ref.execute(check=True)
    s = Session(JobSpec("merge", exec_backend="scalar", **GC_SMALL),
                device="cpu")
    out = s.execute(real=True, check=True)
    assert _same_outputs(out, ref_out)
    ref_msgs, ref_bytes = _tables(ref.transport_stats)
    assert [g.ands for g in s.gate_counts] == [ref_bytes // 32] * 2
    assert _tables(s.transport_stats) == (ref_msgs, ref_bytes)
    rep = s.plan_reports[0].replacement
    for st, rst in zip(s.engine_stats, ref.engine_stats):
        assert st.batches == 0 and st.swap_ins == rep.swap_ins > 0
        assert (st.io_read_bytes, st.io_write_bytes) == \
            (rst.io_read_bytes, rst.io_write_bytes)
        assert st.instructions == rst.instructions


@pytest.mark.parametrize("mode", ["unbounded", "memory"])
@pytest.mark.parametrize("backend", ["batched", "scalar"])
def test_ckks_matches_reference(mode, backend):
    """rmvmul n=4 at ring 128: unbounded, and the scalar loop at a budget
    that swaps, bitwise against the reference (its default backend is the
    scalar loop)."""
    job = dict(n=4, plan_mode=mode, exec_backend=backend) \
        if mode == "unbounded" else dict(CKKS_SMALL, exec_backend=backend)
    ref = RefSession(RefJobSpec(workload="rmvmul", driver="ckks", **job))
    ref_out = ref.execute(check=True)
    s = Session(JobSpec("rmvmul", **job), device="cpu")
    out = s.execute(check=True)
    assert _same_outputs(out, ref_out)
    assert s.engine_stats[0].instructions == ref.engine_stats[0].instructions
    if mode == "unbounded":
        _check_unbounded(s)
    else:
        assert _swaps(s)[0][2:] == (ref.engine_stats[0].io_read_bytes,
                                    ref.engine_stats[0].io_write_bytes)
        assert s.engine_stats[0].swap_ins > 0
    assert (s.engine_stats[0].batches > 0) == (backend == "batched")


def test_unbounded_engine_refuses_swaps():
    s = Session(JobSpec("rmvmul", plan_mode="unbounded", n=4), device="cpu")
    prog = s.plan()[0]
    bad = dataclasses.replace(prog, instrs=list(prog.instrs))
    bad.instrs.insert(0, Instr(Op.SWAP_IN, outs=((0, prog.page_slots),),
                               imm=(0,)))
    s._planned = [bad]
    with pytest.raises(ValueError, match="SWAP_IN"):
        s.execute(check=False)


# ---------------------------------------------------------------------------
# the swap file
# ---------------------------------------------------------------------------

#: (workload, spec): async prefetch, bypassed reads, synchronous swaps, the
#: scalar loop, and a GC job
MEMMAP_JOBS = [
    ("rmvmul", dict(CKKS_SMALL)),
    ("rmvmul", dict(CKKS_SMALL, swap_bypass=True)),
    ("rstats", dict(n=8, memory_budget=3, prefetch_pages=0)),
    ("rmvmul", dict(CKKS_SMALL, exec_backend="scalar", policy="lru")),
    ("merge", dict(GC_SMALL)),
]


@pytest.mark.parametrize("wl,job", MEMMAP_JOBS,
                         ids=["prefetch", "bypass", "sync", "scalar-lru",
                              "gc"])
def test_memmap_matches_ram(wl, job):
    ram = Session(JobSpec(wl, **job), device="cpu")
    want = ram.execute(real=True, check=True)
    s = Session(JobSpec(wl, storage="memmap", **job), device="cpu")
    out = s.execute(real=True, check=True)
    assert _same_outputs(out, want)
    assert _swaps(s) == _swaps(ram) and _swaps(s)[0][0] > 0
    if ram.protocol == "gc":
        assert _tables(s.transport_stats) == _tables(ram.transport_stats)
    else:
        assert torch.equal(s.engines[0].memory, ram.engines[0].memory)
    assert len(s.storages) == len(s.engines)
    for st in s.storages:
        assert isinstance(st, MemmapStorage)
        assert os.path.basename(st.path).startswith("mage_swap_")
        assert not os.path.exists(st.path)
    rep = s.plan_reports[0].schedule
    if job.get("swap_bypass"):
        assert rep.bypass_hits > 0


def _memmap_session() -> Session:
    return Session(JobSpec("rmvmul", storage="memmap", **CKKS_SMALL),
                   device="cpu")


def test_memmap_removed_after_driver_failure(monkeypatch):
    s = _memmap_session()
    seen = []
    real = CkksDriver.execute

    def failing(self, op, imm, outs, ins):
        if op == Op.CT_RELIN:
            seen.append(os.path.exists(s.storages[0].path))
            raise RuntimeError("injected driver failure")
        return real(self, op, imm, outs, ins)

    monkeypatch.setattr(CkksDriver, "execute", failing)
    with pytest.raises(RuntimeError, match="injected"):
        s.execute()
    assert seen == [True]
    assert not os.path.exists(s.storages[0].path)


def test_memmap_write_error_surfaces(monkeypatch):
    """A failed file write on an I/O thread fails the run and still
    removes the file."""
    s = _memmap_session()

    def broken(self, vpage, data):
        raise OSError("injected write failure")

    monkeypatch.setattr(MemmapStorage, "write", broken)
    with pytest.raises(OSError, match="injected"):
        s.execute()
    assert not os.path.exists(s.storages[0].path)


def test_file_swap_io_moves_pages():
    """Every swap directive's data path through the swap file (the CPU
    branch; the card's is in tests/test_torch_cuda.py and chip_smoke.py):
    a write then a read of one page in program order, a bypassed read from
    the prefetch buffer, the synchronous bounce page, byte accounting."""
    dev = torch.device("cpu")
    st = MemmapStorage([3, 7, 9], (4, 2), torch.int64, dev)
    assert os.path.getsize(st.path) == 3 * 4 * 2 * 8
    io = FileSwapIO(st, torch.zeros((2, 4, 2), dtype=torch.int64), dev)
    frame = torch.arange(8, dtype=torch.int64).view(4, 2)
    io.write_sync(3, frame)                        # SWAP_OUT
    io.copy_out(1, frame * 2)                      # COPY_OUT
    io.issue_write(7, 1)                           # ISSUE_SWAP_OUT
    io.issue_read(7, 0)                            # after the write of 7
    a, b, c = (torch.zeros_like(frame) for _ in range(3))
    io.finish_read(0, b)                           # FINISH_SWAP_IN
    io.copy_out(0, frame * 3)
    io.issue_write(9, 0)
    io.finish_read(0, c)                           # bypassed: from pf[0]
    io.read_sync(3, a)                             # SWAP_IN
    io.flush()
    assert torch.equal(a, frame) and torch.equal(b, frame * 2)
    assert torch.equal(c, frame * 3)
    got = np.zeros((4, 2), np.int64)
    st.read(9, got)
    assert np.array_equal(got, (frame * 3).numpy())
    assert io.bytes_read == 2 * 64 and io.bytes_written == 3 * 64
    with pytest.raises(KeyError):
        io.issue_read(5, 0)
    io.close()
    st.close()
    st.close()                                     # twice is fine
    assert not os.path.exists(st.path)


# ---------------------------------------------------------------------------
# the JobSpec and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(plan_mode="unbounded", memory_budget=5),
    dict(plan_mode="memory"),
    dict(plan_mode="paged", memory_budget=5),
    dict(exec_backend="vector", memory_budget=5),
    dict(policy="opt", memory_budget=5),
    dict(storage="disk", memory_budget=5),
], ids=["unbounded-budget", "no-budget", "mode", "backend", "policy",
        "storage"])
def test_jobspec_rejects(bad):
    with pytest.raises(ValueError):
        JobSpec("merge", **bad)


@pytest.mark.parametrize("knob,item", [
    (dict(plan_mode="streaming"), "item 6"),
    (dict(exec_backend="overlap"), "item 4")])
def test_jobspec_not_ported_yet(knob, item):
    """The streaming planner still raises, naming its ROADMAP item; the
    overlap backend (item 4) is ported and accepted."""
    if item == "item 4":
        spec = JobSpec("merge", memory_budget=5, num_workers=4, **knob)
        assert (spec.exec_backend, spec.num_workers) == ("overlap", 4)
        return
    with pytest.raises(NotImplementedError, match=item):
        JobSpec("merge", memory_budget=5, **knob)


def test_jobspec_defaults():
    s = JobSpec("merge", memory_budget=5)
    assert (s.plan_mode, s.exec_backend, s.policy, s.swap_bypass,
            s.storage) == ("memory", "batched", "min", False, "ram")
    assert JobSpec("merge", plan_mode="unbounded").memory_budget is None


def _cli_json(capsys, argv) -> dict:
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_cli_unbounded(capsys):
    got = _cli_json(capsys, ["exec", "--workload", "merge", "-n", "32",
                             "--real", "--check", "--device", "cpu"])
    spec = Session(JobSpec("merge", n=32, plan_mode="unbounded"),
                   device="cpu").trace()[0]
    assert got["spec"]["plan_mode"] == "unbounded"
    assert got["spec"]["num_frames"] is None and got["checked"]
    assert got["frame_bytes"] == [spec.vspace_slots * 16] * 2
    assert got["swap_ins"] == got["swap_outs"] == [0, 0]


def test_cli_knobs(capsys):
    got = _cli_json(capsys, [
        "exec", "--workload", "rmvmul", "-n", "4", "--budget", "3",
        "--prefetch", "1", "--policy", "lru", "--swap-bypass",
        "--exec-backend", "scalar", "--storage", "memmap", "--check",
        "--device", "cpu"])
    assert {k: got["spec"][k] for k in ("plan_mode", "policy", "swap_bypass",
                                        "exec_backend", "storage")} == {
        "plan_mode": "memory", "policy": "lru", "swap_bypass": True,
        "exec_backend": "scalar", "storage": "memmap"}
    assert got["checked"] and got["swap_ins"][0] > 0
    assert "batch_schedule_s" not in got["timings_s"]


def test_cli_refuses_budget_with_unbounded(capsys):
    argv = ["exec", "--workload", "rmvmul", "-n", "4", "--mode", "unbounded",
            "--budget", "4", "--device", "cpu"]
    assert cli.main(argv) == 2
    assert "no memory_budget" in capsys.readouterr().err
