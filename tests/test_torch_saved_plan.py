"""Saved plans in the port against the JAX package on the CPU.

* ``JobSpec.plan_hash`` equals the reference's over a grid of specs (int
  and float budgets, CKKS rings, ``n=None``, every policy knob).
* Program files: a ``ProgramWriter`` / ``ProgramFile`` round trip, each
  package reading the other's files; a plan saved by the port has the
  records and header fields of the reference's ``save_plan`` of the same
  spec, and the same stamped hash.
* Reference plans: job directories from the reference's ``plan`` command
  (``--mode memory``, its default streaming mode, and unbounded) load with
  ``Session.from_plan`` and run equal to the oracle and to the port's
  in-process run; an unbounded plan saved by the port runs too.
* Refusals: an edited ``job.json``, a swapped program file, a missing one
  and an unknown field raise ``SpecMismatchError`` / ``ValueError`` (exit
  2 / 1 from the CLI).
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest

from repro.__main__ import main as ref_main
from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core import bytecode as ref_bc
from repro_torch import __main__ as cli
from repro_torch.api import JOB_FILE, JobSpec, Session, SpecMismatchError
from repro_torch.core import bytecode as bc
from repro_torch.core.bytecode import Instr, Op, Program

from _torch_gc_jobs import same_outputs

HASH_SPECS = [
    dict(workload="merge", n=64, memory_budget=10),
    dict(workload="merge", memory_budget=0.25, prefetch_pages=4),
    dict(workload="merge", n=16384, memory_budget=0.4, lookahead=10_000,
         prefetch_pages=64),
    dict(workload="sort", n=256, num_workers=4, memory_budget=0.4,
         lookahead=100, prefetch_pages=16, policy="lru", swap_bypass=True),
    dict(workload="ljoin", n=16, memory_budget=5, policy="min_clean",
         exec_backend="scalar", storage="memmap"),
    dict(workload="binfclayer", memory_budget=1.0, policy="fifo"),
    dict(workload="rsum", n=32, num_workers=2, memory_budget=3,
         ckks_ring=128),
    dict(workload="rmvmul", n=24, memory_budget=0.4, prefetch_pages=8,
         ckks_ring=1024, ckks_levels=2),
    dict(workload="pir", plan_mode="unbounded"),
]


@pytest.mark.parametrize("spec", HASH_SPECS, ids=lambda d: "-".join(
    f"{v}" for v in d.values()))
def test_plan_hash_is_the_references(spec):
    ours = JobSpec(**spec)
    assert ours.plan_hash() == RefJobSpec(**spec).plan_hash()
    assert len(ours.plan_hash()) == 16
    # execution details stay out of the hash
    assert dataclasses.replace(ours, exec_backend="overlap",
                               transport="tcp").plan_hash() == \
        ours.plan_hash()


def _program() -> Program:
    instrs = [Instr(Op.INPUT, outs=((0, 4),), imm=(4, 0, 7)),
              Instr(Op.ADD, outs=((8, 4),), ins=((0, 4), (4, 4)), imm=(32,)),
              Instr(Op.CT_MUL_PLAIN, outs=((16, 2),), ins=((8, 2),),
                    imm=(2.5, -1, 3)),
              Instr(Op.FREE, ins=((0, 4),)),
              Instr(Op.NET_SEND, ins=((8, 4),), imm=(1, 9))] * 5
    return Program(instrs=instrs, page_shift=3, protocol="gc",
                   phase="memory", worker=1, num_workers=2,
                   vspace_slots=640, num_frames=6, prefetch_slots=2,
                   meta={"spec_hash": "0123456789abcdef",
                         "plan": {"num_frames": 6}})


def _same_file(a, b) -> None:
    for k in bc._HEADER_FIELDS:
        assert getattr(a, k) == getattr(b, k), k
    assert len(a) == len(b)
    ra = np.concatenate([r for _, r in a.iter_chunks(7)])
    rb = np.concatenate([r for _, r in b.iter_chunks(7)])
    assert np.array_equal(ra, rb)


def test_program_file_roundtrip(tmp_path):
    prog = _program()
    pf = bc.write_program(prog, tmp_path / "p.bc", chunk_instrs=4)
    back = pf.read_program()
    assert back.instrs == prog.instrs and back.meta == prog.meta
    assert len(pf) == len(prog) == pf.num_records
    assert (tmp_path / "p.bc").stat().st_size == \
        12 + len(json.dumps({**{k: getattr(prog, k)
                                for k in bc._HEADER_FIELDS},
                             "record_words": bc.RECORD_WORDS,
                             "meta": prog.meta})) + 25 * bc.RECORD_BYTES
    starts = [s for s, _ in pf.iter_chunks(8, reverse=True)]
    assert starts == [24, 16, 8, 0]
    stripped = bc.write_program(prog, tmp_path / "s.bc", strip_free=True)
    assert len(stripped) == 20
    # each package reads the other's files
    ref = ref_bc.write_program(ref_bc.ProgramFile(pf.path).read_program(),
                               tmp_path / "r.bc")
    _same_file(bc.ProgramFile(ref.path), pf)
    assert bc.ProgramFile(ref.path).read_program().instrs == prog.instrs
    with bc.writer_like(prog, tmp_path / "w.bc", phase="virtual",
                        chunk_instrs=4) as w:
        w.append(prog.instrs[0])
        w.extend(prog.instrs[1:])
    back = bc.ProgramFile(tmp_path / "w.bc")
    assert back.phase == "virtual" and back.read_program().instrs == \
        prog.instrs
    (tmp_path / "bad.bc").write_bytes(b"NOTMAGE!" + b"\0" * 8)
    with pytest.raises(ValueError, match="not a MAGE bytecode file"):
        bc.ProgramFile(tmp_path / "bad.bc")
    raw = (tmp_path / "p.bc").read_bytes()
    (tmp_path / "cut.bc").write_bytes(raw[:-8])
    with pytest.raises(ValueError, match="truncated"):
        bc.ProgramFile(tmp_path / "cut.bc")


@pytest.mark.parametrize("spec", [
    dict(workload="merge", n=64, num_workers=2, memory_budget=5,
         prefetch_pages=1),
    dict(workload="rsum", n=32, num_workers=2, memory_budget=3,
         prefetch_pages=1, ckks_ring=128)], ids=["merge", "rsum"])
def test_saved_plan_is_the_references(tmp_path, spec):
    ours = Session(JobSpec(**spec), device="cpu")
    manifest = json.loads(open(ours.save_plan(tmp_path / "port")).read())
    ref = RefSession(RefJobSpec(**spec))
    ref_manifest = json.loads(open(ref.save_plan(tmp_path / "ref")).read())
    assert manifest["spec_hash"] == ref_manifest["spec_hash"]
    assert manifest["programs"] == ref_manifest["programs"]
    for name in manifest["programs"]:
        a = bc.ProgramFile(tmp_path / "port" / name)
        b = ref_bc.ProgramFile(tmp_path / "ref" / name)
        _same_file(a, b)
        assert a.meta["spec_hash"] == b.meta["spec_hash"]
        assert a.meta["job_spec"] == JobSpec.from_dict(
            b.meta["job_spec"]).to_dict() | {"exec_backend": "batched"}


def _ref_plan(tmp_path, name: str, *args) -> str:
    job = str(tmp_path / name)
    assert ref_main(["plan", *args, "--out", job]) == 0
    return job


@pytest.mark.parametrize("args", [
    ("--workload", "merge", "-n", "64", "--workers", "2", "--budget", "10",
     "--lookahead", "40", "--prefetch", "2", "--mode", "memory"),
    ("--workload", "merge", "-n", "64", "--workers", "2", "--budget", "10",
     "--lookahead", "40", "--prefetch", "2"),
    ("--workload", "merge", "-n", "64"),
    ("--workload", "rsum", "-n", "32", "--budget", "4", "--prefetch", "1",
     "--ckks-ring", "128", "--mode", "memory")],
    ids=["memory", "streaming", "unbounded", "ckks"])
def test_reference_plans_run_in_the_port(tmp_path, args):
    job = _ref_plan(tmp_path, "job", *args)
    s = Session.from_plan(job, device="cpu")
    assert s.spec.exec_backend == "scalar"      # the reference's default
    assert s.spec.plan_mode in ("memory", "unbounded")
    out = s.execute(real=None, check=True)
    mine = Session(dataclasses.replace(s.spec, exec_backend="batched"),
                   device="cpu")
    want = mine.execute(real=None)
    assert [p.instrs for p in mine.plan()] == [p.instrs for p in s.plan()]
    if s.protocol == "gc":
        assert same_outputs(out, want)
    else:
        assert all(np.array_equal(out[k], want[k]) for k in want)
    assert cli.main(["run", job, "--check", "--device", "cpu"]) == 0


def test_port_unbounded_plan_runs(tmp_path, capsys):
    job = str(tmp_path / "job")
    assert cli.main(["plan", "--workload", "merge", "-n", "32", "--out", job,
                     "--device", "cpu"]) == 0
    s = Session.from_plan(job, device="cpu")
    assert s.spec.plan_mode == "unbounded"
    assert [p.phase for p in s.plan()] == ["virtual"]
    assert cli.main(["run", job, "--real", "--check", "--device",
                     "cpu"]) == 0
    assert "oracle check OK" in capsys.readouterr().out
    with pytest.raises(ValueError, match="virtual-phase"):
        s.adopt_plan([Session(JobSpec("merge", n=32, memory_budget=6),
                              device="cpu").plan()[0]])
    with pytest.raises(ValueError, match="memory-phase"):
        Session(JobSpec("merge", n=32, memory_budget=6),
                device="cpu").adopt_plan(s.plan())


def test_tampered_plans_are_refused(tmp_path, capsys):
    plan = ["plan", "--workload", "merge", "-n", "64", "--budget", "6",
            "--prefetch", "1", "--device", "cpu"]
    job, other = tmp_path / "job", tmp_path / "other"
    assert cli.main(plan + ["--out", str(job)]) == 0
    assert cli.main(plan[:-2] + ["--budget", "8", "--device", "cpu",
                                 "--out", str(other)]) == 0
    manifest = json.loads((job / JOB_FILE).read_text())

    def edit(**spec):
        d = json.loads(json.dumps(manifest))
        d["spec"].update(spec)
        (job / JOB_FILE).write_text(json.dumps(d))

    edit(n=128)                                  # edited job.json
    with pytest.raises(SpecMismatchError, match="modified after planning"):
        Session.from_plan(job, device="cpu")
    with pytest.raises(SystemExit) as e:
        cli.main(["run", str(job), "--device", "cpu"])
    assert e.value.code == 2
    edit(bogus=1)                                # an unknown field
    with pytest.raises(ValueError, match="unknown JobSpec fields"):
        Session.from_plan(job, device="cpu")
    with pytest.raises(SystemExit) as e:
        cli.main(["run", str(job), "--device", "cpu"])
    assert e.value.code == 1
    edit()
    assert Session.from_plan(job, device="cpu").spec.n == 64
    shutil.copy(other / "worker0.memory.bc", job / "worker0.memory.bc")
    with pytest.raises(SpecMismatchError, match="artifact and spec"):
        Session.from_plan(job, device="cpu")
    (job / "worker0.memory.bc").unlink()
    with pytest.raises(FileNotFoundError):
        Session.from_plan(job, device="cpu")
    capsys.readouterr()


def test_manifest_fields_of_the_reference_are_read():
    """The reference's ``to_dict`` carries fields the port does not run
    (its planner cores, the streaming planner's files); they are read and
    ignored, and the rest keeps its meaning."""
    ref = RefJobSpec(workload="merge", n=64, memory_budget=10,
                     plan_core="scalar", chunk_instrs=4096,
                     exec_backend="overlap").normalized()
    ours = JobSpec.from_dict(ref.to_dict())
    assert ours.exec_backend == "overlap" and ours.driver == "gc-plaintext"
    assert ours.plan_hash() == ref.plan_hash()
    with pytest.raises(ValueError, match="unknown JobSpec fields"):
        JobSpec.from_dict({**ours.to_dict(), "colour": "blue"})
