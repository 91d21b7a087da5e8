"""Streaming jobs in the port's Session and CLI, on the CPU.

* ``JobSpec(plan_mode="streaming")`` plans each worker's program out of
  core and the engine runs the memory-program files: a two-party merge
  equals the memory-mode run (outputs, AND gates, the garbled-table
  digest, swap counts, the plans' records) on the scalar, batched and
  overlap loops at one worker a party, and batched at two; CKKS rsum at
  ring 128 equals the JAX package's streaming Session bit for bit; the
  swap file works on a streamed plan.
* The Session's temporary directory is gone after ``close()`` (and
  after a ``with`` block); a ``workdir`` the caller gives stays.
* The JobSpec knobs are the reference's: ``workdir`` and
  ``track_plan_memory``; the plan hash ignores them.  Its ``plan_core``
  and ``chunk_instrs`` (which leave the plans as they are) are read from
  its manifests and ignored.
* A memory-program file runs across many chunks (a schedule cut at 8
  records) as the in-memory program runs, on each loop.
* ``plan`` saves a streaming plan by default and ``run JOBDIR`` executes
  its files without reading a program into memory (a spy counts
  ``ProgramFile.read_program`` calls)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro_torch import __main__ as cli
from repro_torch.api import (JOB_FILE, NOT_PORTED, REFERENCE_ONLY_FIELDS,
                             JobSpec, Session)
from repro_torch.core.bytecode import ProgramFile, encode_chunk, write_program
from repro_torch.core.engine import Engine, swapped_pages
from repro_torch.core.liveness import file_digest, records_digest
from repro_torch.core.storage import PinnedStorage
from repro_torch.exec.batched_gc import BatchedPlaintextDriver
from repro_torch.exec.batching import build_batch_schedule
from repro_torch.exec.overlap import build_overlap_schedule
from repro_torch.protocols.garbled.driver import PlaintextDriver

from _torch_gc_jobs import job, same_outputs

MERGE = job("merge")


def _digest(prog) -> int:
    if isinstance(prog, ProgramFile):
        return file_digest(prog)
    return records_digest(0, encode_chunk(prog.instrs), 0)


def _result(s: Session, out: dict) -> dict:
    return {"outputs": out, "ands": [g.ands for g in s.gate_counts],
            "digest": s.table_digest,
            "swaps": [(e.swap_ins, e.swap_outs) for e in s.engine_stats],
            "plans": [_digest(p) for p in s.plan()]}


def _run(workers: int, **knobs) -> dict:
    with Session(JobSpec("merge", num_workers=workers, **MERGE, **knobs),
                 device="cpu") as s:
        out = s.execute(real=True, check=True, digest=True)
        res = _result(s, out)
        if knobs.get("plan_mode") == "streaming":
            assert all(isinstance(p, ProgramFile) for p in s.plan())
            assert s.timings["annotate_s"] > 0
            tmp = s._tmpdir
            assert os.path.isdir(tmp)
    if knobs.get("plan_mode") == "streaming":
        assert not os.path.exists(tmp)
    return res


@pytest.fixture(scope="module")
def memory_runs():
    return {}


def _same(a: dict, b: dict) -> None:
    assert same_outputs(a["outputs"], b["outputs"])
    for k in ("ands", "digest", "swaps", "plans"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("workers,loop", [(1, "scalar"), (1, "batched"),
                                          (1, "overlap"), (2, "batched")])
def test_streamed_gc_equals_memory_mode(memory_runs, workers, loop):
    if workers not in memory_runs:
        memory_runs[workers] = _run(workers)
    want = memory_runs[workers]
    assert all(i > 0 for i, _ in want["swaps"])
    _same(_run(workers, plan_mode="streaming", exec_backend=loop), want)


def test_streamed_ckks_is_the_references():
    spec = dict(n=64, memory_budget=4, prefetch_pages=1, lookahead=100,
                ckks_ring=128, plan_mode="streaming")
    with RefSession(RefJobSpec(workload="rsum", **spec)) as ref:
        want = ref.execute(check=True)
        rplans = [np.vstack([c for _, c in p.iter_chunks()])
                  for p in ref.plan()]
    with Session(JobSpec("rsum", **spec), device="cpu") as s:
        got = s.execute(check=True)
        assert sum(e.swap_ins for e in s.engine_stats) > 0
        plans = [np.vstack([c for _, c in p.iter_chunks()])
                 for p in s.plan()]
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert all(np.array_equal(a, b) for a, b in zip(plans, rplans))


def test_memmap_storage_and_workdir(tmp_path):
    spec = JobSpec("merge", **MERGE, plan_mode="streaming",
                   storage="memmap", workdir=str(tmp_path / "wd"),
                   track_plan_memory=True)
    with Session(spec, device="cpu") as s:
        out = s.execute(real=False, check=True)
        assert s.storages and not any(os.path.exists(st.path)
                                      for st in s.storages)
        assert s._tmpdir is None
        assert s.timings["peak_mem_bytes"] > 0
        assert s.plan()[0].path == str(tmp_path / "wd" / "worker0" /
                                       "memory.bc")
    assert os.path.exists(tmp_path / "wd" / "worker0" / "memory.bc")
    with Session(dataclasses.replace(spec, plan_mode="memory",
                                     storage="ram"), device="cpu") as m:
        assert same_outputs(out, m.execute(real=False, check=True))


def _engine_run(prog, workload, loop: str, chunk=None) -> tuple:
    """One plaintext engine over ``prog`` on ``loop``, its schedule (if
    any) cut at ``chunk`` records: outputs, swaps, instructions."""
    cpu = torch.device("cpu")
    drv = PlaintextDriver(workload.inputs(MERGE["n"], 0, 1))
    storage = PinnedStorage(swapped_pages(prog), (prog.page_slots, drv.lane),
                            drv.dtype, cpu)
    kw = {"batched": lambda: {"batch_schedule":
                              build_batch_schedule(prog, chunk)},
          "overlap": lambda: {"overlap_schedule":
                              build_overlap_schedule(prog, chunk)},
          "scalar": dict}[loop]()
    eng = Engine(prog, BatchedPlaintextDriver(drv) if kw else drv, cpu,
                 storage, **kw)
    try:
        eng.run()
    finally:
        storage.close()
    return drv.outputs, (eng.stats.swap_ins, eng.stats.swap_outs), \
        eng.stats.instructions


@pytest.mark.parametrize("loop", ["scalar", "batched", "overlap"])
def test_a_file_runs_across_its_chunks(tmp_path, loop):
    with Session(JobSpec("merge", **MERGE), device="cpu") as s:
        prog = s.plan()[0]
        w = s.workload
    pf = write_program(prog, tmp_path / "m.bc", chunk_instrs=8)
    assert len(pf) > 4 * 8
    want = _engine_run(prog, w, loop)
    got = _engine_run(pf, w, loop, chunk=8)
    assert same_outputs(got[0], want[0]) and want[1][0] > 0
    assert got[1:] == want[1:]


def test_close_removes_the_temporary_directory():
    s = Session(JobSpec("merge", **MERGE, plan_mode="streaming"),
                device="cpu")
    planned = s.plan()
    tmp = s._tmpdir
    assert planned[0].path.startswith(tmp)
    s.close()
    assert not os.path.exists(tmp) and s._tmpdir is None
    s.close()                                    # closing twice is fine


def test_jobspec_knobs_are_the_references():
    assert not NOT_PORTED
    assert REFERENCE_ONLY_FIELDS == ("plan_core", "sim_core", "chunk_instrs")
    ours = JobSpec("merge", n=64, memory_budget=5, plan_mode="streaming",
                   workdir="/nowhere", track_plan_memory=True)
    plain = JobSpec("merge", n=64, memory_budget=5)
    assert ours.plan_hash() == plain.plan_hash() == RefJobSpec(
        workload="merge", n=64, memory_budget=5).plan_hash()
    defaults = RefJobSpec(workload="merge", memory_budget=5)
    for k in ("workdir", "track_plan_memory"):
        assert getattr(JobSpec("merge", memory_budget=5), k) == \
            getattr(defaults, k), k
    ref = RefJobSpec(workload="merge", n=64, memory_budget=5,
                     plan_mode="streaming", plan_core="scalar",
                     chunk_instrs=64).normalized()
    back = JobSpec.from_dict(ref.to_dict())
    assert back.plan_mode == "streaming"
    assert not {"plan_core", "chunk_instrs"} & set(back.to_dict())
    for k in ("plan_core", "chunk_instrs"):
        with pytest.raises(TypeError, match=k):
            JobSpec("merge", memory_budget=5, **{k: 64})


def test_plan_defaults_to_streaming_and_run_reads_no_program(
        tmp_path, capsys, monkeypatch):
    reads = []
    real_read = ProgramFile.read_program

    def spy(self):
        reads.append(self.path)
        return real_read(self)

    monkeypatch.setattr(ProgramFile, "read_program", spy)
    job_dir = tmp_path / "job"
    assert cli.main(["plan", "--workload", "merge", "-n", "64", "--budget",
                     "5", "--prefetch", "1", "--lookahead", "50",
                     "--workers", "2", "--out", str(job_dir),
                     "--device", "cpu"]) == 0
    manifest = json.loads((job_dir / JOB_FILE).read_text())
    assert manifest["spec"]["plan_mode"] == "streaming"
    assert sorted(os.listdir(job_dir)) == [
        JOB_FILE, "worker0.memory.bc", "worker1.memory.bc"]
    s = Session.from_plan(job_dir, device="cpu")
    assert all(isinstance(p, ProgramFile) for p in s.plan())
    assert cli.main(["run", str(job_dir), "--check", "--device", "cpu"]) == 0
    assert cli.main(["run", str(job_dir), "--check", "--exec-backend",
                     "overlap", "--device", "cpu"]) == 0
    assert "oracle check OK" in capsys.readouterr().out
    assert reads == []
    # the same plan, made in memory
    mem = tmp_path / "mem"
    assert cli.main(["plan", "--workload", "merge", "-n", "64", "--budget",
                     "5", "--prefetch", "1", "--lookahead", "50",
                     "--workers", "2", "--mode", "memory", "--out",
                     str(mem), "--device", "cpu"]) == 0
    for w in (0, 1):
        name = f"worker{w}.memory.bc"
        assert file_digest(ProgramFile(mem / name)) == \
            file_digest(ProgramFile(job_dir / name))
    capsys.readouterr()
    assert cli.main(["exec", "--workload", "merge", "-n", "64", "--budget",
                     "5", "--prefetch", "1", "--mode", "streaming",
                     "--check", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert (got["spec"]["plan_mode"], got["checked"]) == ("streaming", True)
    assert got["swap_ins"][0] > 0 and got["timings_s"]["annotate_s"] > 0
