"""The port's out-of-core planner against the JAX package's, on the CPU.

* The next-use sidecar (``annotate_next_use``) of merge, sort and rsum
  traces is byte for byte the reference's, at two chunk sizes, with the
  same ``file_digest``; a stale or foreign sidecar, a file with FREEs and
  a file that is no sidecar are refused.
* ``plan_streaming``'s memory program equals the reference's
  ``plan_streaming`` and the port's ``plan()`` record for record, for
  every policy, with and without swap bypass, without and with a
  prefetch buffer, with equal stage statistics; intermediates and a
  failed plan's directory are removed as in the reference.
* ``plan_workers`` at two workers plans the same in serial, thread and
  process mode, in memory and streamed (the spawned planner gets files).
* ``working_set_pages_stream`` equals the reference's.
* The planner's tracemalloc peak stays flat while a program grows 4x
  (the reference's ``table1_planning.py --streaming`` claim, at test
  size)."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core import bytecode as ref_bc
from repro.core.liveness import (annotate_next_use as ref_annotate,
                                 working_set_pages_stream as ref_ws_stream)
from repro.core.planner import (PlanConfig as RefPlanConfig,
                                plan_memory_estimate as ref_estimate,
                                plan_streaming as ref_plan_streaming)
from repro_torch.api import JobSpec, Session
from repro_torch.core.bytecode import (Op, ProgramFile, ProgramWriter,
                                       RECORD_WORDS, _IMM_OFF, _IN_OFF,
                                       _OUT_OFF, encode_chunk, write_program)
from repro_torch.core.liveness import (ANN_MAGIC, AnnotationReader,
                                       annotate_next_use, file_digest,
                                       records_digest,
                                       working_set_pages_stream)
from repro_torch.core.planner import (PlanConfig, plan, plan_memory_estimate,
                                      plan_streaming)
from repro_torch.core.replacement import plan_replacement_file
from repro_torch.core.workers import plan_workers

ALL_POLICIES = ("min", "min_clean", "lru", "fifo")
#: (workload, n, spec knobs): a GC merge and sort, a CKKS sum at ring 128
TRACES = [("merge", 128, {}), ("sort", 64, {}),
          ("rsum", 32, {"ckks_ring": 128})]


def _traces(wl: str, n: int, knobs: dict):
    """The port's and the reference's traced program of one job."""
    spec = dict(n=n, plan_mode="unbounded", **knobs)
    return (Session(JobSpec(wl, **spec), device="cpu").trace()[0],
            RefSession(RefJobSpec(workload=wl, **spec)).trace()[0])


@pytest.fixture(scope="module")
def merge_traces():
    return _traces("merge", 128, {})


@pytest.mark.parametrize("chunk", (7, 8192))
@pytest.mark.parametrize("wl,n,knobs", TRACES, ids=[t[0] for t in TRACES])
def test_sidecar_is_the_references(tmp_path, wl, n, knobs, chunk):
    port, ref = _traces(wl, n, knobs)
    pf = write_program(port, tmp_path / "p.bc", strip_free=True,
                       chunk_instrs=chunk)
    rf = ref_bc.write_program(ref, tmp_path / "r.bc", strip_free=True,
                              chunk_instrs=chunk)
    info = annotate_next_use(pf, tmp_path / "p.ann", chunk)
    rinfo = ref_annotate(rf, tmp_path / "r.ann", chunk)
    mine = (tmp_path / "p.ann").read_bytes()
    assert mine[:8] == ANN_MAGIC
    assert mine == (tmp_path / "r.ann").read_bytes()
    assert (info.n_records, info.num_pages, info.max_touches,
            info.prog_crc) == (rinfo.n_records, rinfo.num_pages,
                               rinfo.max_touches, rinfo.prog_crc)
    assert file_digest(pf, chunk) == file_digest(pf) == info.prog_crc
    assert info.prog_crc == records_digest(
        0, encode_chunk([i for i in port.instrs if i.op != Op.FREE]), 0)
    reader = AnnotationReader(info.path)
    assert (reader.n_records, reader.num_pages, reader.prog_crc) == \
        (len(pf), info.num_pages, info.prog_crc)
    assert sum(a.shape[0] for _, a in reader.iter_chunks(5)) == len(pf)


def test_stale_and_foreign_sidecars_are_refused(tmp_path, merge_traces):
    port, _ = merge_traces
    pf = write_program(port, tmp_path / "v.bc", strip_free=True)
    # same record count and touches, other content: the digest catches it
    recs = np.vstack([c for _, c in pf.iter_chunks()]).copy()
    assert recs[-1, 0] & 0xFFFF == int(Op.OUTPUT)
    recs[-1, _IMM_OFF + 2] += 1                 # the last output's tag
    w = ProgramWriter(tmp_path / "o.bc", page_shift=pf.page_shift,
                      protocol=pf.protocol, vspace_slots=pf.vspace_slots)
    w.append_records(recs)
    other = w.close()
    ann = annotate_next_use(other, tmp_path / "o.ann")
    with pytest.raises(ValueError, match="does not match"):
        plan_replacement_file(pf, tmp_path / "p.bc", 8, annotations=ann.path)
    # another record count
    short = write_program(dataclasses.replace(
        port, instrs=[i for i in port.instrs if i.op != Op.FREE][:-3]),
        tmp_path / "s.bc")
    sann = annotate_next_use(short, tmp_path / "s.ann")
    with pytest.raises(ValueError, match="stale"):
        plan_replacement_file(pf, tmp_path / "p.bc", 8, annotations=sann.path)
    with pytest.raises(ValueError, match="not a MAGE annotation"):
        AnnotationReader(pf.path)
    with pytest.raises(ValueError, match="FREE"):
        annotate_next_use(write_program(port, tmp_path / "f.bc"),
                          tmp_path / "f.ann")
    # the reference's sidecar of the same program is accepted
    rann = ref_annotate(ref_bc.ProgramFile(pf.path), tmp_path / "r.ann")
    got, _ = plan_replacement_file(pf, tmp_path / "q.bc", 8,
                                   annotations=rann.path)
    assert len(got) > len(pf)


@pytest.mark.parametrize("prefetch", (0, 2))
@pytest.mark.parametrize("bypass", (False, True), ids=("sync", "bypass"))
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_plan_streaming_is_the_references(tmp_path, merge_traces, policy,
                                          bypass, prefetch):
    port, ref = merge_traces
    cfg = PlanConfig(num_frames=7, lookahead=40, prefetch_pages=prefetch,
                     policy=policy, swap_bypass=bypass)
    memf, rep = plan_streaming(port, cfg, workdir=tmp_path / "p",
                               chunk_instrs=13)
    rmemf, rrep = ref_plan_streaming(
        ref, RefPlanConfig(**dataclasses.asdict(cfg)),
        workdir=tmp_path / "r", chunk_instrs=13)
    mem, mrep = plan(port, cfg)
    mine = np.vstack([c for _, c in memf.iter_chunks()])
    assert np.array_equal(mine, np.vstack([c for _, c in
                                           rmemf.iter_chunks()]))
    assert np.array_equal(mine, encode_chunk(mem.instrs))
    assert (memf.phase, memf.num_frames, memf.prefetch_slots) == \
        (mem.phase, mem.num_frames, mem.prefetch_slots) == \
        ("memory", cfg.replacement_frames, prefetch)
    assert memf.meta["plan"] == mem.meta["plan"] == dataclasses.asdict(cfg)
    for a, b in ((rep, rrep), (rep, mrep)):
        assert dataclasses.asdict(a.replacement) == \
            dataclasses.asdict(b.replacement)
        assert dataclasses.asdict(a.schedule) == \
            dataclasses.asdict(b.schedule)
    assert rep.replacement.swap_ins > 0 and rep.annotate_s > 0
    # intermediates are gone: the memory program is all that is left
    assert sorted(os.listdir(tmp_path / "p")) == ["memory.bc"]


def test_plan_streaming_files_and_failures(tmp_path, merge_traces,
                                           monkeypatch):
    port, _ = merge_traces
    cfg = PlanConfig(num_frames=7, lookahead=40, prefetch_pages=2)
    want = file_digest(plan_streaming(port, cfg, workdir=tmp_path / "a")[0])
    kept, _ = plan_streaming(port, cfg, workdir=tmp_path / "k",
                             keep_intermediates=True)
    assert sorted(os.listdir(tmp_path / "k")) == \
        ["memory.bc", "physical.bc", "virtual.ann", "virtual.bc"]
    # a pre-computed sidecar skips the backward pass and stays the caller's
    memf, rep = plan_streaming(ProgramFile(tmp_path / "k" / "virtual.bc"),
                               cfg,
                               workdir=tmp_path / "b",
                               annotations=tmp_path / "k" / "virtual.ann")
    assert rep.annotate_s == 0 and file_digest(memf) == want
    assert os.path.exists(tmp_path / "k" / "virtual.ann")
    # without a workdir, a failed plan leaves no directory behind
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "t"))
    os.makedirs(tmp_path / "t")
    with pytest.raises(ValueError, match="budget too small"):
        plan_streaming(port, PlanConfig(num_frames=1))
    with pytest.raises(ValueError, match="prefetch"):
        plan_streaming(port, PlanConfig(num_frames=4, prefetch_pages=4))
    assert os.listdir(tmp_path / "t") == []
    for c in (cfg, PlanConfig(num_frames=4096, lookahead=7)):
        assert plan_memory_estimate(c, 512) == \
            ref_estimate(RefPlanConfig(**dataclasses.asdict(c)), 512)


@pytest.mark.parametrize("streaming", (False, True),
                         ids=("memory", "streaming"))
def test_plan_workers_modes_agree(tmp_path, streaming):
    progs = Session(JobSpec("merge", n=256, num_workers=2,
                            plan_mode="unbounded"), device="cpu").trace()
    cfg = PlanConfig(num_frames=6, lookahead=100, prefetch_pages=1)
    want = [records_digest(0, encode_chunk(m.instrs), 0)
            for m in plan_workers(progs, cfg)[0]]
    for mode in ("serial", "thread", "process"):
        wd = tmp_path / mode
        planned, reps = plan_workers(progs, cfg, parallel=mode,
                                     streaming=streaming,
                                     workdir=str(wd) if streaming else None,
                                     track_memory=True)
        got = [file_digest(p) if streaming else
               records_digest(0, encode_chunk(p.instrs), 0)
               for p in planned]
        assert got == want, mode
        assert all(r.peak_mem_bytes > 0 for r in reps)
        assert all(r.replacement.swap_ins > 0 for r in reps)
        if streaming:
            assert [p.worker for p in planned] == [0, 1]
            assert sorted(os.listdir(wd)) == ["worker0", "worker1"]
            for w in (0, 1):
                assert os.listdir(wd / f"worker{w}") == ["memory.bc"]


@pytest.mark.parametrize("wl,n,knobs", TRACES, ids=[t[0] for t in TRACES])
def test_working_set_stream_is_the_references(tmp_path, wl, n, knobs):
    port, ref = _traces(wl, n, knobs)
    want = ref_ws_stream(ref)
    assert working_set_pages_stream(port) == want
    assert working_set_pages_stream(port, chunk_instrs=3) == want
    pf = write_program(port, tmp_path / "v.bc", strip_free=True)
    assert working_set_pages_stream(pf, chunk_instrs=5) == want


def _synthetic_file(path, n: int, live_pages: int = 256,
                    page_shift: int = 6, seed: int = 0):
    """A GC-like virtual program of ``n`` whole-page ADDs, writes round
    robin over ``live_pages`` and reads mostly nearby (the reference's
    ``table1_planning.synth_instrs`` shape), written as records."""
    psize = 1 << page_shift
    rng = np.random.default_rng(seed)
    rec = np.zeros((n, RECORD_WORDS), dtype=np.int64)
    k = np.arange(n, dtype=np.int64)
    head = int(Op.ADD) | 1 << 16 | 2 << 20
    rec[:, 0] = np.where(k < live_pages, int(Op.INPUT) | 1 << 16 | 1 << 24,
                         head)
    wp = k % live_pages
    near = (wp - rng.integers(1, 64, n)) % live_pages
    far = rng.integers(0, live_pages, n)
    a = np.where(rng.random(n) < 0.9, near, far)
    b = (wp - rng.integers(1, 128, n)) % live_pages
    rec[:, _OUT_OFF], rec[:, _OUT_OFF + 1] = wp * psize, psize
    body = k >= live_pages
    rec[body, _IN_OFF], rec[body, _IN_OFF + 1] = a[body] * psize, psize
    rec[body, _IN_OFF + 2], rec[body, _IN_OFF + 3] = b[body] * psize, psize
    rec[~body, _IMM_OFF] = k[~body]             # INPUT's tag
    w = ProgramWriter(path, page_shift=page_shift, protocol="gc",
                      vspace_slots=live_pages << page_shift)
    w.append_records(rec)
    return w.close()


def test_planner_peak_stays_flat(tmp_path):
    """Planner memory is O(chunk + frames + lookahead), whatever the
    program's length: 4x the instructions, and the tracemalloc peak grows
    less than the reference's sweep allows (max(4 / 4, 2) = 2x) and stays
    under its 8 MiB cap (``benchmarks/table1_planning.py``)."""
    cfg = PlanConfig(num_frames=64 + 8, lookahead=200, prefetch_pages=8)
    peaks, sizes = [], (4000, 16000)
    for n in sizes:
        pf = _synthetic_file(tmp_path / f"v{n}.bc", n)
        memf, rep = plan_streaming(pf, cfg, workdir=tmp_path / f"w{n}",
                                   track_memory=True, chunk_instrs=512)
        assert rep.replacement.swap_ins > 0 and len(memf) > n
        peaks.append(rep.peak_mem_bytes)
    growth = peaks[1] / peaks[0]
    assert growth < max(sizes[1] / sizes[0] / 4, 2.0), peaks
    assert max(peaks) <= 8 * 2**20, peaks
