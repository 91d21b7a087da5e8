"""The port's record-array planner cores against its scalar cores and the
JAX package's array cores, bit for bit.

Replacement (every policy), scheduling (with and without swap bypass),
the file stages and the whole ``plan()`` in memory and streamed give
memory programs whose records equal the scalar core's and the
reference's, with equal stage statistics, on random programs (the
reference's planner tests' generator, carried over as records) and on a
swap-heavy one that takes the write-allocate elision and dropped-dirty
paths.  A custom ``EvictionPolicy`` falls back to the scalar core; a bad
``core`` raises."""

import dataclasses

import numpy as np
import pytest

from test_core_planner import _random_program as _ref_random_program

from repro.core import PlanConfig as RefPlanConfig, plan as ref_plan
from repro.core.bytecode import encode_chunk as ref_encode
from repro_torch.core.bytecode import (Instr, Op, Program, encode_chunk,
                                       write_program)
from repro_torch.core.liveness import (file_digest, records_digest,
                                       stripped_touches, touches_from_records,
                                       working_set_pages,
                                       working_set_pages_stream)
from repro_torch.core.planner import PlanConfig, plan, plan_streaming
from repro_torch.core.replacement import (MinPolicy, plan_replacement,
                                          plan_replacement_file)
from repro_torch.core.scheduling import plan_schedule, plan_schedule_file
from repro_torch.interop import program_from_records

ALL_POLICIES = ("min", "min_clean", "lru", "fifo")


def _random_program(seed: int) -> tuple[Program, object]:
    """The reference planner tests' random program (FREEs included), in
    the port's terms and the reference's."""
    ref = _ref_random_program(seed)
    port = program_from_records(ref_encode(ref.instrs), {
        "page_shift": ref.page_shift, "phase": ref.phase, "num_frames": 0,
        "prefetch_slots": 0, "vspace_slots": ref.vspace_slots, "meta": {},
        "protocol": ref.protocol})
    return port, ref


def _swapheavy_program(n=3000, live_pages=128, page_shift=6, seed=3):
    """Whole-page values, round-robin writes: eviction pressure that takes
    write-allocate elision and dropped-dirty write-backs."""
    psize = 1 << page_shift
    rng = np.random.default_rng(seed)
    instrs = [Instr(Op.INPUT, outs=((p * psize, psize),), imm=(p,))
              for p in range(live_pages)]
    for i in range(n - live_pages):
        wp = i % live_pages
        a = int(rng.integers(0, live_pages))
        b = int(rng.integers(0, live_pages))
        instrs.append(Instr(Op.ADD, outs=((wp * psize, psize),),
                            ins=((a * psize, psize), (b * psize, psize))))
    return Program(instrs=instrs, page_shift=page_shift, protocol="gc",
                   vspace_slots=live_pages << page_shift)


def _digest(instrs) -> int:
    return records_digest(0, encode_chunk(instrs), 0)


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("seed", (0, 7))
def test_replacement_cores_identical(policy, seed):
    prog, _ = _random_program(seed)
    ps, ss = plan_replacement(prog, 7, policy=policy, core="scalar")
    pa, sa = plan_replacement(prog, 7, policy=policy, core="array")
    assert pa.instrs == ps.instrs
    assert sa == ss
    assert ss.swap_ins + ss.swap_outs > 0


@pytest.mark.parametrize("swap_bypass", (False, True))
@pytest.mark.parametrize("seed", (0, 7))
def test_schedule_cores_identical(swap_bypass, seed):
    prog, _ = _random_program(seed)
    phys, _ = plan_replacement(prog, 7, core="scalar")
    ms, ss = plan_schedule(phys, 11, 2, swap_bypass=swap_bypass,
                           core="scalar")
    ma, sa = plan_schedule(phys, 11, 2, swap_bypass=swap_bypass,
                           core="array", chunk_instrs=13)
    assert ma.instrs == ms.instrs
    assert sa == ss


def test_file_stage_cores_identical(tmp_path):
    prog, _ = _random_program(11)
    vpf = write_program(prog, tmp_path / "v.bc", strip_free=True,
                        chunk_instrs=9)
    ps, ss = plan_replacement_file(vpf, tmp_path / "ps.bc", 7, core="scalar")
    pa, sa = plan_replacement_file(vpf, tmp_path / "pa.bc", 7, core="array")
    assert file_digest(pa) == file_digest(ps)
    assert sa == ss
    ms, sss = plan_schedule_file(ps, tmp_path / "ms.bc", 12, 2,
                                 core="scalar")
    ma, ssa = plan_schedule_file(pa, tmp_path / "ma.bc", 12, 2,
                                 core="array")
    assert file_digest(ma) == file_digest(ms)
    assert ssa == sss
    # the sidecars the file stages wrote beside their outputs are gone
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["ma.bc", "ms.bc", "pa.bc", "ps.bc", "v.bc"]


@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("streaming", (False, True),
                         ids=("memory", "streaming"))
def test_plan_cores_identical(policy, streaming, tmp_path):
    """The fused ``plan()`` and ``plan_streaming`` on either core equal
    each other and the reference's array-core ``plan()``."""
    prog, ref = _random_program(5)
    cfg_s = PlanConfig(num_frames=7, lookahead=11, prefetch_pages=2,
                       policy=policy, swap_bypass=True, core="scalar")
    cfg_a = dataclasses.replace(cfg_s, core="array")
    if streaming:
        mem_s, rep_s = plan_streaming(prog, cfg_s, workdir=tmp_path / "s",
                                      chunk_instrs=13)
        mem_a, rep_a = plan_streaming(prog, cfg_a, workdir=tmp_path / "a",
                                      chunk_instrs=13)
        ds, da = file_digest(mem_s), file_digest(mem_a)
    else:
        mem_s, rep_s = plan(prog, cfg_s)
        mem_a, rep_a = plan(prog, cfg_a)
        ds, da = _digest(mem_s.instrs), _digest(mem_a.instrs)
    rm, rrep = ref_plan(ref, RefPlanConfig(**dataclasses.asdict(cfg_a)))
    assert da == ds == records_digest(0, ref_encode(rm.instrs), 0)
    assert rep_a.replacement == rep_s.replacement
    assert rep_a.schedule == rep_s.schedule
    assert dataclasses.asdict(rep_a.replacement) == \
        dataclasses.asdict(rrep.replacement)
    assert dataclasses.asdict(rep_a.schedule) == \
        dataclasses.asdict(rrep.schedule)


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_cores_identical_on_swapheavy_edge_paths(policy, tmp_path):
    """The elision, dropped-dirty and synchronous-degrade paths, in
    memory and streamed."""
    prog = _swapheavy_program()
    cfg_s = PlanConfig(num_frames=40, lookahead=64, prefetch_pages=4,
                       policy=policy, core="scalar")
    cfg_a = dataclasses.replace(cfg_s, core="array")
    mem_s, rep_s = plan(prog, cfg_s)
    mem_a, rep_a = plan(prog, cfg_a)
    assert mem_a.instrs == mem_s.instrs
    assert rep_a.replacement == rep_s.replacement
    assert rep_a.schedule == rep_s.schedule
    assert rep_a.replacement.elided_swap_ins > 0
    assert rep_a.replacement.dropped_dirty > 0
    memf, repf = plan_streaming(prog, cfg_a, workdir=tmp_path,
                                chunk_instrs=256)
    assert file_digest(memf) == _digest(mem_s.instrs)
    assert repf.replacement == rep_s.replacement


def test_swap_bypass_path_covered():
    hits = 0
    for seed in range(8):
        prog, _ = _random_program(seed)
        cfg_s = PlanConfig(num_frames=7, lookahead=30, prefetch_pages=2,
                           swap_bypass=True, core="scalar")
        mem_s, rep_s = plan(prog, cfg_s)
        mem_a, rep_a = plan(prog, dataclasses.replace(cfg_s, core="array"))
        assert mem_a.instrs == mem_s.instrs
        assert rep_a.schedule == rep_s.schedule
        hits += rep_a.schedule.bypass_hits
    assert hits > 0, "no seed took the bypass path"


def test_custom_policy_falls_back_to_scalar_core():
    prog, _ = _random_program(2)
    pa, sa = plan_replacement(prog, 7, policy=MinPolicy(), core="array")
    ps, ss = plan_replacement(prog, 7, policy="min", core="scalar")
    assert pa.instrs == ps.instrs
    assert (sa.swap_ins, sa.swap_outs) == (ss.swap_ins, ss.swap_outs)


def test_bad_core_rejected(tmp_path):
    prog, _ = _random_program(0)
    with pytest.raises(ValueError, match="core"):
        plan_replacement(prog, 7, core="simd")
    with pytest.raises(ValueError, match="policy"):
        plan_replacement(prog, 7, policy="opt")
    vpf = write_program(prog, tmp_path / "v.bc", strip_free=True)
    with pytest.raises(ValueError, match="core"):
        plan_replacement_file(vpf, tmp_path / "p.bc", 7, core="simd")


@pytest.mark.parametrize("seed", (0, 4, 9))
def test_touches_and_working_set_match_scalar(seed):
    prog, ref = _random_program(seed)
    instrs, t = stripped_touches(prog)
    tv = touches_from_records(encode_chunk(instrs), prog.page_shift,
                              prog.page_slots, chunk_instrs=7)
    for f in ("offsets", "pages", "flags", "next_any", "next_read"):
        assert np.array_equal(getattr(tv, f), getattr(t, f)), f
    assert tv.num_pages == t.num_pages
    assert working_set_pages_stream(prog, chunk_instrs=5) == \
        working_set_pages(t)
