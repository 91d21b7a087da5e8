"""The port's §8.2 timing simulator, cost models, scenarios and ``bench``
against the JAX package's, on the CPU.

* Cost models: per instruction, bit for bit, equal to the reference's on
  seeded random instructions and on traced programs: ``gate_cost`` and
  ``gate_cost_chunk``, ``GCCostModel`` as garbler and as evaluator
  (``cost``, ``cost_chunk``, ``bytes_of``, ``bytes_chunk``),
  ``CkksCostModel`` at rings 2^6..2^13, ``ScenarioCost``'s ``cost_chunk``
  equal to its ``__call__``.
* ``gate_cost``'s AND counts equal the port's real ``GateCounts`` for every
  op the workloads use (the reference's
  ``test_gate_cost_formulas_match_counters``).
* The three simulators on the reference's own plans (crossed as records
  through ``interop.program_from_records``): the port's scalar cores equal
  the reference's scalar cores on every ``SimResult`` field, exactly; the
  port's array cores equal its scalar cores exactly at chunk sizes 7, 64
  and the default, on ``Program``s and on ``ProgramFile``s; the
  reference's array cores (compensated ``sum()`` under Python 3.12) within
  1e-12 relative.  Cases: the reference's ``test_array_sim.py`` set.
* ``Session.simulate`` and ``run_bench`` / ``run_sweep`` / ``bench --tiny
  --json`` equal the reference's scalar-core results; ``simulate`` refuses
  unbounded and ``from_plan`` sessions; ``bench`` raises without a card
  unless given ``--device cpu``.
"""

import dataclasses
import functools
import json
import math

import numpy as np
import pytest
import torch

from repro import scenarios as ref_sc
from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core import simulator as ref_sim
from repro.core.bytecode import (Instr as RefInstr, Op as RefOp,
                                 encode_chunk as ref_encode)
from repro.protocols.ckks.driver import CkksCostModel as RefCkksCost
from repro.protocols.garbled import cost as ref_cost
from repro_torch import __main__ as cli
from repro_torch import scenarios as sc
from repro_torch.api import JobSpec, Session, WorkerScenarios
from repro_torch.core import simulator as sim
from repro_torch.core.bytecode import (MAX_IMM, Instr, Op, ProgramFile,
                                       encode_chunk, unpack_heads,
                                       write_program)
from repro_torch.core.dsl import trace
from repro_torch.interop import program_from_records
from repro_torch.protocols.ckks import CkksCostModel
from repro_torch.protocols.garbled import cost
from repro_torch.protocols.garbled.driver import GarblerDriver
from repro_torch.protocols.garbled.dsl import Integer, Party

CHUNKS = (7, 64, None)       # None: the default chunk (DEFAULT_CHUNK_INSTRS)
REL = 1e-12


def _chunk(c):
    return {} if c is None else {"chunk_instrs": c}


# ---------------------------------------------------------------------------
# cost models, per instruction
# ---------------------------------------------------------------------------

_GC_OPS = [Op.ADD, Op.SUB, Op.MUL, Op.CMP_GE, Op.CMP_EQ, Op.SELECT, Op.XOR,
           Op.AND, Op.OR, Op.NOT, Op.MINMAX, Op.SORT_LOCAL, Op.PAIR_JOIN,
           Op.MAC8, Op.XNOR_POP_SIGN, Op.REDUCE_ADD, Op.REVERSE, Op.INPUT,
           Op.OUTPUT, Op.COPY, Op.NET_SEND, Op.NET_RECV, Op.SWAP_IN,
           Op.ISSUE_SWAP_OUT]


def _random_gc_batch(seed: int, m: int = 96):
    """The reference's random GC instruction mix (its test_array_sim.py)."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(m):
        op = _GC_OPS[int(rng.integers(0, len(_GC_OPS)))]
        n = int(rng.integers(1, 400))
        w = int(rng.integers(1, 65))
        kw = int(rng.integers(1, 65))
        if op == Op.SORT_LOCAL:
            if rng.random() < 0.7:
                n = 1 << int(rng.integers(1, 10))
            imm = (n, w, kw, 0, int(rng.integers(0, 2))) \
                if rng.random() < 0.5 else (n, w, kw)
        elif op == Op.PAIR_JOIN:
            imm = (n, int(rng.integers(1, 200)), w, kw)
        elif op == Op.MAC8:
            imm = (n, int(rng.integers(1, 600)), int(rng.integers(16, 65)))
        elif op == Op.XNOR_POP_SIGN:
            imm = (n, int(rng.integers(1, 3000)))
        else:
            imm = (n, w, kw)
        cases.append((op, imm))
    ops = np.array([int(o) for o, _ in cases], dtype=np.int64)
    imm = np.zeros((m, MAX_IMM), dtype=np.int64)
    n_imm = np.zeros(m, dtype=np.int64)
    for i, (_, im) in enumerate(cases):
        imm[i, :len(im)] = im
        n_imm[i] = len(im)
    return cases, ops, imm, n_imm


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("role", ["garbler", "evaluator"])
def test_gc_cost_models_equal_reference(seed, role):
    cases, ops, imm, n_imm = _random_gc_batch(seed)
    va, vc = cost.gate_cost_chunk(ops, imm, n_imm)
    ra, rc = ref_cost.gate_cost_chunk(ops, imm, n_imm)
    assert np.array_equal(va, ra) and np.array_equal(vc, rc)
    model, ref = cost.GCCostModel(role=role), \
        ref_cost.GCCostModel(role=role)
    cv, rcv = model.cost_chunk(ops, imm, n_imm), ref.cost_chunk(ops, imm,
                                                                n_imm)
    assert cv.tobytes() == rcv.tobytes()
    bv = model.bytes_chunk(ops, imm, n_imm)
    assert np.array_equal(bv, ref.bytes_chunk(ops, imm, n_imm))
    for i, (op, im) in enumerate(cases):
        assert cost.gate_cost(op, im) == ref_cost.gate_cost(RefOp(op), im) \
            == (va[i], vc[i]), (op.name, im)
        got = model.cost(Instr(op, imm=im))
        assert got == ref.cost(RefInstr(RefOp(op), imm=im)) == cv[i]
        assert model.bytes_of(Instr(op, imm=im)) == bv[i]


@pytest.mark.parametrize("ring_log2", range(6, 14))
def test_ckks_cost_model_equals_reference(ring_log2):
    rng = np.random.default_rng(ring_log2)
    n_ring = 1 << ring_log2
    ckks_ops = [Op.CT_ADD, Op.CT_MUL, Op.CT_MUL_NR, Op.CT_RELIN,
                Op.CT_ADD_PLAIN, Op.CT_MUL_PLAIN, Op.INPUT, Op.OUTPUT,
                Op.COPY, Op.NET_SEND, Op.SWAP_OUT]
    cases = [(ckks_ops[int(rng.integers(0, len(ckks_ops)))],
              (int(rng.integers(0, 8)), int(rng.integers(2, 4)),
               int(rng.integers(2, 4)))) for _ in range(64)]
    ops = np.array([int(o) for o, _ in cases], dtype=np.int64)
    imm = np.zeros((len(cases), MAX_IMM), dtype=np.int64)
    for i, (_, im) in enumerate(cases):
        imm[i, :len(im)] = im
    for pointwise in (0.3e-9, 1.2e-9):
        model = CkksCostModel(pointwise=pointwise)
        ref = RefCkksCost(pointwise=pointwise)
        cv = model.cost_chunk(ops, imm, n_ring)
        assert cv.tobytes() == ref.cost_chunk(ops, imm, n_ring).tobytes()
        for i, (op, im) in enumerate(cases):
            got = model.cost(Instr(op, imm=im), n_ring)
            assert got == ref.cost(RefInstr(RefOp(op), imm=im), n_ring) \
                == cv[i], (op.name, im)


@pytest.mark.parametrize("protocol,workload,n", [("gc", "merge", 512),
                                                 ("ckks", "rsum", 64)])
def test_scenario_cost_on_traced_programs(protocol, workload, n):
    """``ScenarioCost`` (the protocol formulas + the INPUT/OUTPUT
    file-streaming bytes): ``cost_chunk`` equals ``__call__`` and both
    equal the reference's, per instruction, on a real trace."""
    with Session(sc.scenario_spec(workload, n, budget_frac=0.5),
                 device="cpu") as s:
        prog = s.trace()[0]
    instrs = [i for i in prog.instrs if i.op != Op.FREE]
    rec = encode_chunk(instrs)
    c, ref = sc.cost_fn(protocol), ref_sc.cost_fn(protocol)
    chunk = c.cost_chunk(rec)
    assert chunk.tobytes() == ref.cost_chunk(rec).tobytes()
    ops = unpack_heads(rec[:, 0])[0]
    assert ((ops == int(Op.INPUT)) | (ops == int(Op.OUTPUT))).any()
    for i, ins in enumerate(instrs):
        rins = RefInstr(RefOp(ins.op), ins.outs, ins.ins, ins.imm)
        assert c(ins) == chunk[i] == ref(rins), (i, ins.op.name)


class _Sink:
    """A party channel that drops what the garbler sends."""

    def send(self, kind, t):
        pass


def test_gate_cost_equals_real_gate_counts():
    """The analytic AND counts the simulator prices equal the port's
    garbler's real counters for every op the workloads use."""
    cases = []

    def program():
        a = Integer(32, 8).mark_input(Party.Garbler, 0)
        b = Integer(32, 8).mark_input(Party.Garbler, 1)
        cases.append(a + b)
        cases.append(a - b)
        cases.append(a * b)
        cases.append(a.cmp_ge(b))
        cases.append(a.cmp_eq(b))
        mn, mx = a.minmax(b, 32)
        s = a.sort_local(32)
        j = a.pair_join(b, 32)
        r = a.reduce_add()
        for v, t in [(mn, 100), (mx, 101), (s, 102), (j, 103), (r, 104)]:
            v.mark_output(t)
        for i, v in enumerate(cases):
            v.mark_output(i)

    prog = trace(program, protocol="gc", page_shift=13)
    d = GarblerDriver(_Sink(), torch.device("cpu"),
                      lambda t: np.zeros(8, dtype=np.uint64), seed=1)
    seen = set()
    for ins in prog.instrs:
        if ins.op in (Op.FREE, Op.OUTPUT):
            continue
        before = d.gates.counts.ands
        outs = [torch.zeros((s[1], 2), dtype=torch.int64) for s in ins.outs]
        ins_ = [torch.zeros((s[1], 2), dtype=torch.int64) for s in ins.ins]
        d.execute(ins.op, ins.imm, outs, ins_)
        formula, _ = cost.gate_cost(ins.op, ins.imm)
        assert d.gates.counts.ands - before == formula, \
            (ins.op.name, ins.imm)
        seen.add(ins.op)
    assert {Op.ADD, Op.SUB, Op.MUL, Op.CMP_GE, Op.CMP_EQ, Op.MINMAX,
            Op.SORT_LOCAL, Op.PAIR_JOIN, Op.REDUCE_ADD} <= seen


# ---------------------------------------------------------------------------
# the simulators on the reference's own plans
# ---------------------------------------------------------------------------


def _cross(prog):
    """A reference Program as the port's Program, through records."""
    return program_from_records(ref_encode(prog.instrs), {
        "page_shift": prog.page_shift, "phase": prog.phase,
        "num_frames": prog.num_frames, "prefetch_slots": prog.prefetch_slots,
        "vspace_slots": prog.vspace_slots, "meta": {},
        "protocol": prog.protocol, "worker": prog.worker,
        "num_workers": prog.num_workers})


@functools.lru_cache(maxsize=None)
def _reference_case(name: str, n: int, workers: int, plan_mode: str):
    """The reference's scenario Session for one case, simulated on its
    scalar cores: its WorkerScenarios, and each worker's virtual and
    memory programs (a streaming plan's files read whole) in the
    reference's terms."""
    spec = ref_sc.scenario_spec(name, n, budget_frac=0.4,
                                num_workers=workers, plan_mode=plan_mode,
                                sim_core="scalar")
    with RefSession(spec) as s:
        res = s.simulate(ref_sc.cost_fn(s.protocol), model=ref_sc.STORAGE,
                         os_page_bytes=ref_sc.OS_PAGE_BYTES)
        virt = list(s.trace())
        mem = [p if hasattr(p, "instrs") else p.read_program()
               for p in s.plan()]
    return res, virt, mem


SIM_CASES = [("merge", 1024, 2), ("rsum", 64, 1)]


def _assert_same_sim(got, want) -> None:
    """Every SimResult field equal (the reference's is another class)."""
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("plan_mode", ("memory", "streaming"))
@pytest.mark.parametrize("name,n,workers", SIM_CASES)
def test_session_simulate_equals_reference(name, n, workers, plan_mode):
    """The port's own plan, simulated on both cores through
    ``Session.simulate``, equals the reference's scalar cores on every
    SimResult field (two workers: NET_SEND accounting)."""
    ref, _, _ = _reference_case(name, n, workers, plan_mode)
    spec = sc.scenario_spec(name, n, budget_frac=0.4, num_workers=workers,
                            plan_mode=plan_mode)
    with Session(spec, device="cpu") as s:
        runs = [s.simulate(sc.cost_fn(s.protocol), model=sc.STORAGE,
                           os_page_bytes=sc.OS_PAGE_BYTES, core=core)
                for core in ("array", "scalar")]
    for got in runs:
        assert len(got) == len(ref) == workers
        for g, r in zip(got, ref):
            assert isinstance(g, WorkerScenarios)
            for field in ("unbounded", "os", "mage"):
                _assert_same_sim(getattr(g, field), getattr(r, field))
            assert (g.working_set_pages, g.page_bytes, g.instructions,
                    g.config.num_frames) == \
                (r.working_set_pages, r.page_bytes, r.instructions,
                 r.config.num_frames)
            if plan_mode == "memory":
                assert g.program_bytes == r.program_bytes
    if workers > 1:
        assert all(w.mage.net_msgs > 0 and w.mage.net_bytes > 0
                   for w in runs[0])


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("plan_mode", ("memory", "streaming"))
@pytest.mark.parametrize("name,n,workers", SIM_CASES)
def test_cores_on_reference_plans(name, n, workers, plan_mode, chunk,
                                  tmp_path):
    """On the reference's programs: the port's scalar cores = the
    reference's scalar cores; the port's array cores = its scalar cores
    at this chunk size, on Programs and on ProgramFiles; the reference's
    array cores within 1e-12 relative."""
    ref, ref_virt, ref_mem = _reference_case(name, n, workers, plan_mode)
    cost = sc.cost_fn(ref_virt[0].protocol)
    ref_cost_fn = ref_sc.cost_fn(ref_virt[0].protocol)
    for wk, (rv_prog, rm_prog) in enumerate(zip(ref_virt, ref_mem)):
        v, m = _cross(rv_prog), _cross(rm_prog)
        page_bytes = v.page_slots * (16 if v.protocol == "gc" else 8)
        frames = ref[wk].config.num_frames

        def run(vp, mp, core, **kw):
            return (sim.simulate_unbounded(vp, cost, core=core, **kw),
                    sim.simulate_os_paging(vp, cost, frames, page_bytes,
                                           sc.STORAGE,
                                           os_page_bytes=sc.OS_PAGE_BYTES,
                                           core=core, **kw),
                    sim.simulate_memory_program(mp, cost, page_bytes,
                                                sc.STORAGE, core=core, **kw))

        scalar = run(v, m, "scalar")
        for got, want in zip(scalar, (ref[wk].unbounded, ref[wk].os,
                                      ref[wk].mage)):
            _assert_same_sim(got, want)
        vpf = write_program(v, tmp_path / f"v{wk}.bc", strip_free=True)
        mpf = write_program(m, tmp_path / f"m{wk}.bc")
        for src_v, src_m in ((v, m), (vpf, mpf)):
            assert run(src_v, src_m, "array", **_chunk(chunk)) == scalar
        # the reference's array cores add with the compensated sum()
        ref_arr = (
            ref_sim.simulate_unbounded(rv_prog, ref_cost_fn, core="array",
                                       **_chunk(chunk)),
            ref_sim.simulate_os_paging(
                rv_prog, ref_cost_fn, frames, page_bytes, ref_sc.STORAGE,
                os_page_bytes=ref_sc.OS_PAGE_BYTES, core="array",
                **_chunk(chunk)),
            ref_sim.simulate_memory_program(
                rm_prog, ref_cost_fn, page_bytes, ref_sc.STORAGE,
                core="array", **_chunk(chunk)))
        for got, want in zip(ref_arr, scalar):
            for f in ("total", "compute", "stall", "net_stall"):
                assert math.isclose(getattr(got, f), getattr(want, f),
                                    rel_tol=REL, abs_tol=0.0), f
            assert (got.reads, got.writes, got.read_bytes, got.write_bytes,
                    got.net_msgs, got.net_bytes) == \
                (want.reads, want.writes, want.read_bytes, want.write_bytes,
                 want.net_msgs, want.net_bytes)


def _swap_heavy(mod, n=600, live_pages=32, page_shift=6):
    psize = 1 << page_shift
    rng = np.random.default_rng(5)
    instrs = [mod.Instr(mod.Op.INPUT, outs=((p * psize, psize),), imm=(p,))
              for p in range(live_pages)]
    for i in range(n):
        wp = i % live_pages
        a = int(rng.integers(0, live_pages))
        instrs.append(mod.Instr(mod.Op.ADD, outs=((wp * psize, psize),),
                                ins=((a * psize, psize),), imm=(1, 32)))
    return mod.Program(instrs=instrs, page_shift=page_shift, protocol="gc",
                       vspace_slots=live_pages << page_shift)


def _thrash(mod, pages=96, reps=6, page_shift=6, self_read=False):
    psize = 1 << page_shift
    instrs = [mod.Instr(mod.Op.INPUT, outs=((p * psize, psize),), imm=(p,))
              for p in range(pages)]
    for _ in range(reps):
        for p in range(pages):
            ins = ((p * psize, psize),) if self_read else ()
            instrs.append(mod.Instr(mod.Op.ADD, outs=((p * psize, psize),),
                                    ins=ins, imm=(1, 32)))
    return mod.Program(instrs=instrs, page_shift=page_shift, protocol="gc",
                       vspace_slots=pages << page_shift)


def _both(builder, **kw):
    """The same program built in the port's terms and the reference's."""
    import repro.core.bytecode as rb
    import repro_torch.core.bytecode as tb
    return builder(tb, **kw), builder(rb, **kw)


def _os_three_ways(builder, frames, page_bytes, cost_fn, chunk, model=None,
                   os_page_bytes=None, **kw):
    port, ref = _both(builder, **kw)
    rs = ref_sim.simulate_os_paging(ref, cost_fn, frames, page_bytes, model,
                                    os_page_bytes=os_page_bytes,
                                    core="scalar")
    ps = sim.simulate_os_paging(port, cost_fn, frames, page_bytes, model,
                                os_page_bytes=os_page_bytes, core="scalar")
    pa = sim.simulate_os_paging(port, cost_fn, frames, page_bytes, model,
                                os_page_bytes=os_page_bytes, core="array",
                                **_chunk(chunk))
    _assert_same_sim(ps, rs)
    assert pa == ps
    return ps


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"chunk{c}")
def test_writeback_throttle_path(chunk):
    """A throttled device (deep write-back queue blocks the faulter) takes
    the direct-reclaim path on every core, with equal results."""
    throttled = sim.DeviceModel(bandwidth=5e6, latency=1e-5,
                                os_writeback_throttle_s=1e-4)
    free = sim.DeviceModel(bandwidth=5e6, latency=1e-5,
                           os_writeback_throttle_s=math.inf)
    rs = _os_three_ways(_swap_heavy, 8, 1024, lambda ins: 1e-3, chunk,
                        throttled)
    r_free = _os_three_ways(_swap_heavy, 8, 1024, lambda ins: 1e-3, chunk,
                            free)
    assert rs.writes > 0 and rs.stall > r_free.stall


@pytest.mark.parametrize("chunk", (512, None), ids=lambda c: f"chunk{c}")
def test_eviction_path_past_1024_frames(chunk):
    """num_frames above the 1024-candidate snapshot: the argpartition LRU
    victim queue picks the scalar OrderedDict's victims exactly."""
    rs = _os_three_ways(_swap_heavy, 1300, 1024, lambda ins: 1e-7, chunk,
                        n=6000, live_pages=1600)
    assert rs.reads > 0 and rs.writes > 0


@pytest.mark.parametrize("self_read", (False, True))
@pytest.mark.parametrize("frames", (16, 48, 90))
def test_thrashing_fault_runs(frames, self_read):
    for chunk in (256, 7, None):
        rs = _os_three_ways(_thrash, frames, 1024, lambda ins: 1e-7, chunk,
                            self_read=self_read)
    assert rs.reads > 0 and rs.writes > 0


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"chunk{c}")
def test_compute_between_faults(chunk):
    """Costs accrued between faults fold into the batched fault runs in
    the scalar order: seeded per-instruction costs."""
    rng = np.random.default_rng(11)
    costs = rng.uniform(1e-8, 1e-5, 48 * 5)
    seen = {"i": -1}

    def cost_fn(ins):
        seen["i"] += 1
        return float(costs[seen["i"] % len(costs)])

    port, ref = _both(_thrash, pages=48, reps=4)
    out = []
    for fn, prog, core, kw in (
            (ref_sim.simulate_os_paging, ref, "scalar", {}),
            (sim.simulate_os_paging, port, "scalar", {}),
            (sim.simulate_os_paging, port, "array", _chunk(chunk))):
        seen["i"] = -1
        out.append(fn(prog, cost_fn, 20, 1024, core=core, **kw))
    _assert_same_sim(out[1], out[0])
    assert out[2] == out[1]


def test_os_page_bytes_accounting():
    """read_bytes counts whole readahead clusters (which round UP past the
    page size), write_bytes whole-page write-backs."""
    model = sim.DeviceModel(readahead=3)
    r = _os_three_ways(_swap_heavy, 8, 1024, lambda ins: 1e-7, None, model,
                       os_page_bytes=256)
    # page = 1024 B, os_page = 256 B -> 4 os-pages, readahead 3 ->
    # 2 clusters x 768 B = 1536 B actually read per fault
    assert r.reads > 0 and r.read_bytes == r.reads * 2 * 768
    assert r.write_bytes == r.writes * 1024


@functools.lru_cache(maxsize=None)
def _two_worker_merge(plan_mode: str):
    """Worker 0's program of merge n=256 at two workers, unbounded or
    planned at 0.5: the port's and the reference's (the same plan)."""
    kw = dict(workload="merge", n=256, num_workers=2, plan_mode=plan_mode,
              driver="gc-plaintext")
    if plan_mode == "memory":
        kw["memory_budget"] = 0.5
    with RefSession(RefJobSpec(**kw)) as r:
        ref = r.plan()[0]
    with Session(JobSpec(**kw), device="cpu") as s:
        port = s.plan()[0]
    assert encode_chunk(port.instrs).tobytes() == \
        ref_encode(ref.instrs).tobytes()
    return port, ref


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("plan_mode", ("unbounded", "memory"))
@pytest.mark.parametrize("mode", ("inorder", "overlap"))
def test_net_modes_across_cores(mode, plan_mode, chunk):
    port, ref = _two_worker_merge(plan_mode)
    kw = dict(net_latency_s=0.01, net_bandwidth=1e9, net_mode=mode)
    cost_fn = lambda ins: 1e-7  # noqa: E731
    rs = ref_sim.simulate_memory_program(ref, cost_fn, 4096, core="scalar",
                                         **kw)
    ps = sim.simulate_memory_program(port, cost_fn, 4096, core="scalar",
                                     **kw)
    pa = sim.simulate_memory_program(port, cost_fn, 4096, core="array",
                                     **kw, **_chunk(chunk))
    _assert_same_sim(ps, rs)
    assert pa == ps and ps.net_msgs > 1 and ps.net_stall > 0


def test_net_modes_price_the_latency_windows():
    port, _ = _two_worker_merge("unbounded")
    lat = 0.025
    zero = lambda ins: 0.0  # noqa: E731
    ino = sim.simulate_memory_program(port, zero, 4096, net_latency_s=lat)
    ovl = sim.simulate_memory_program(port, zero, 4096, net_latency_s=lat,
                                      net_mode="overlap")
    assert ino.net_msgs == ovl.net_msgs > 1
    assert ino.total == ino.net_stall == pytest.approx(ino.net_msgs * lat)
    assert ovl.total == ovl.net_stall == pytest.approx(lat)
    with pytest.raises(ValueError, match="net_mode"):
        sim.simulate_memory_program(port, zero, 4096, net_mode="banana")
    with pytest.raises(ValueError, match="core"):
        sim.simulate_unbounded(port, zero, core="simd")


# ---------------------------------------------------------------------------
# Session.simulate's refusals, scenarios and bench
# ---------------------------------------------------------------------------


def test_simulate_refuses_unbounded_and_loaded_plans(tmp_path):
    cost_fn = sc.cost_fn("gc")
    with Session(JobSpec("merge", n=64, plan_mode="unbounded"),
                 device="cpu") as s:
        with pytest.raises(ValueError, match="unbounded"):
            s.simulate(cost_fn)
    with Session(JobSpec("merge", n=64, memory_budget=6, prefetch_pages=1),
                 device="cpu") as s:
        s.save_plan(tmp_path / "job")
        assert len(s.simulate(cost_fn)) == 1
    loaded = Session.from_plan(tmp_path / "job", device="cpu")
    with pytest.raises(ValueError, match="from_plan"):
        loaded.simulate(cost_fn)


def _same_rows(rows, ref_rows) -> None:
    """Rows equal on every field but the planner's host measurements.  A
    streaming row's program_bytes is its plan file's size, whose header
    stamps the job's spec: the port's JobSpec lacks the reference's
    ``plan_core``, ``sim_core`` and ``chunk_instrs`` and defaults to
    another engine loop, so only the header's length differs, by what
    ``_header_delta`` measures."""
    assert len(rows) == len(ref_rows)
    for got, want in zip(rows, ref_rows):
        assert set(want) - set(got) == {"sim_core"}
        assert set(got) <= set(want)
        for k in got:
            if k in ("plan_s", "plan_peak_mb"):
                continue
            if k == "program_bytes" and got["plan_mode"] == "streaming":
                delta = _header_delta(got["workload"], got["n"],
                                      got.get("budget_frac", 0.4))
                assert want[k] - got[k] == delta
                continue
            assert got[k] == want[k], (got["workload"], k)


@functools.lru_cache(maxsize=None)
def _header_delta(name: str, n: int, budget: float) -> int:
    """The reference's streaming plan file header length less the port's,
    for the same case (the reference's spec on its scalar simulator core,
    as its rows here are); their records are equal."""
    with RefSession(ref_sc.scenario_spec(name, n, budget,
                                         plan_mode="streaming",
                                         sim_core="scalar")) as r:
        rp = r.plan()[0]
        with Session(sc.scenario_spec(name, n, budget,
                                      plan_mode="streaming"),
                     device="cpu") as s:
            pp = s.plan()[0]
            assert isinstance(pp, ProgramFile)
            assert pp.num_records == rp.num_records
            assert [c.tobytes() for _, c in pp.iter_chunks()] == \
                [c.tobytes() for _, c in rp.iter_chunks()]
            return rp._data_off - pp._data_off


@functools.lru_cache(maxsize=None)
def _reference_tiny_rows():
    return ref_sc.run_bench(ref_sc.TINY_BENCH_CASES, check=False,
                            streaming_case=ref_sc.TINY_STREAMING_CASE,
                            sim_core="scalar")


def test_bench_tiny_json_equals_reference(tmp_path, capsys):
    """``python -m repro_torch bench --tiny --device cpu --json`` writes the
    reference's scalar-core rows (merge 2048, rsum 128 and the tiny
    streaming case, merge 4096 through the file pipeline)."""
    out = tmp_path / "bench.json"
    assert cli.main(["bench", "--tiny", "--device", "cpu", "--json",
                     str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["schema_version"] == 1
    assert [(r["workload"], r["n"], r["plan_mode"]) for r in doc["rows"]] \
        == [("merge", 2048, "memory"), ("rsum", 128, "memory"),
            ("merge", 4096, "streaming")]
    _same_rows(doc["rows"], _reference_tiny_rows())
    assert all(r["os_s"] > r["mage_s"] for r in doc["rows"])
    assert "bench (streaming):" in capsys.readouterr().out


def test_run_bench_and_sweep_equal_reference():
    rows = sc.run_bench([("rsum", 128)], device="cpu")
    _same_rows(rows, _reference_tiny_rows()[1:2])
    kw = dict(budgets=(0.25, 0.6), lookaheads=(100, 10_000))
    rows = sc.run_sweep([("merge", 2048)], device="cpu", **kw)
    ref = ref_sc.run_sweep([("merge", 2048)], sim_core="scalar", **kw)
    assert [(r["budget_frac"], r["lookahead"]) for r in rows] == \
        [(0.25, 100), (0.25, 10_000), (0.6, 100), (0.6, 10_000)]
    _same_rows(rows, ref)


def test_bench_sweep_cli_and_check(tmp_path):
    out = tmp_path / "sweep.json"
    assert cli.main(["bench", "--sweep", "--cases", "rsum=128", "--budgets",
                     "0.4", "--lookaheads", "100", "--device", "cpu",
                     "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["benchmark"] == "bench_sweep"
    assert doc["sweep"] == {"budgets": [0.4], "lookaheads": [100]}
    assert len(doc["rows"]) == 1
    with pytest.raises(SystemExit):
        cli.main(["bench", "--cases", "rsum", "--device", "cpu"])


def test_bench_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench", "--tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.run_workload("rsum", 128)


def test_measure_traffic_counts_the_links():
    """A real run's fabric accounting: merge n=256 at two workers in the
    clear on the CPU, scalar against overlap."""
    a = sc.measure_traffic("merge", 256, num_workers=2, check=True,
                           device="cpu")
    b = sc.measure_traffic("merge", 256, num_workers=2, check=True,
                           exec_backend="overlap", device="cpu")
    assert a.total_bytes == b.total_bytes > 0
    assert a.total_messages == b.total_messages > 0
    assert sorted(a.links) == [(0, 1), (1, 0)]
    assert all(np.array_equal(a.outputs[k], b.outputs[k]) for k in a.outputs)
    assert a.seconds > 0


def test_scenario_result_fields():
    r = sc.run_workload("rsum", 128, budget_frac=0.4, device="cpu")
    ref = ref_sc.run_workload("rsum", 128, budget_frac=0.4,
                              sim_core="scalar")
    assert isinstance(r, sc.ScenarioResult)
    assert r.speedup_vs_os == ref.speedup_vs_os > 1
    assert r.pct_of_unbounded == ref.pct_of_unbounded
    assert sc.fmt_row("rsum", r) == ref_sc.fmt_row("rsum", ref)
    assert sc.fmt_io_row("rsum", r) == ref_sc.fmt_io_row("rsum", ref)
    with pytest.raises(ValueError, match="unknown plan knobs"):
        sc.scenario_spec("merge", 256, plan_overrides={"banana": 1})
