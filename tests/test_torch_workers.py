"""Multi-worker jobs in the port against the JAX package on the CPU.

* In the clear, the JAX package's multi-worker cases
  (``tests/test_workloads.py::test_multiworker_matches_oracle``) on the
  batched, scalar and overlap loops: outputs equal the reference's
  ``gc-plaintext`` / ``ckks`` runs (CKKS at ring 128, bit for bit) and the
  oracle, and every GC engine's final memory equals the reference's.
* Two-party merge n=64 at p=2 on the batched and overlap loops: outputs,
  AND counts, the messages and bytes of every link, and the table digest
  of each party link equal the reference's batched run's.
* Per-worker planning: serial, thread and process give the same plans.
* No fallback: NET_* directives without a worker link raise.
* ``JobSpec(num_workers=4, exec_backend="overlap")`` and the CLI's
  ``--workers 4 --exec-backend overlap`` run.
"""

import functools
import hashlib
import threading

import numpy as np
import pytest

import repro.core.transport as ref_transport
from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core.engine import Engine as RefEngine
from repro.protocols.garbled.driver import PlaintextDriver as RefPlaintext
from repro_torch import __main__ as cli
from repro_torch.api import JobSpec, Session
from repro_torch.core.bytecode import encode_chunk
from repro_torch.core.engine import Engine
from repro_torch.core.transport import TransportError
from repro_torch.exec.overlap import build_overlap_schedule
from repro_torch.protocols.garbled.driver import PlaintextDriver

from _torch_gc_jobs import (assert_workers_match, reference_two_party_links,
                            same_outputs)

BACKENDS = ["batched", "scalar", "overlap"]
#: the JAX package's multi-worker cases (tests/test_workloads.py:34-39)
CLEAR_CASES = [("merge", 256, 2), ("merge", 256, 4), ("sort", 256, 4),
               ("mvmul", 32, 2), ("rsum", 32, 4), ("rstats", 16, 2),
               ("rmvmul", 4, 2), ("ljoin", 32, 2), ("t_rmatmul", 4, 2)]
#: the two-party job: merge n=64 at p=2, planned so that both workers swap
TWO_PARTY = dict(n=64, num_workers=2, memory_budget=5, prefetch_pages=1)


@functools.lru_cache(maxsize=None)
def _reference_clear(wl: str, n: int, p: int):
    """The JAX package's unbounded run of ``wl`` at p workers in the clear
    (its scalar loop): the outputs and, for GC, each worker engine's final
    memory (uint64 slots)."""
    ref = RefSession(RefJobSpec(workload=wl, n=n, num_workers=p,
                                plan_mode="unbounded"))
    if ref.protocol != "gc":
        return ref.execute(check=True), None
    progs = ref.plan()
    view = ref_transport.PartyView(ref_transport.InprocTransport(p), 0, p)
    drivers = [RefPlaintext(ref.workload.inputs(n, k, p)) for k in range(p)]
    engines = [RefEngine(progs[k], drivers[k], net=view) for k in range(p)]
    threads = [threading.Thread(target=e.run) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {}
    for d in drivers:
        out.update(d.outputs)
    return out, [e.memory[:, 0] for e in engines]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("wl,n,p", CLEAR_CASES,
                         ids=[f"{w}-{n}-p{p}" for w, n, p in CLEAR_CASES])
def test_clear_runs_match_reference(wl, n, p, backend):
    ref_out, ref_mem = _reference_clear(wl, n, p)
    s = Session(JobSpec(wl, n=n, num_workers=p, plan_mode="unbounded",
                        exec_backend=backend), device="cpu")
    out = s.execute(real=False, check=True)
    assert same_outputs(out, ref_out)
    assert len(s.engines) == p
    # merge, sort and the partial sums exchange values; the others split
    # their rows and need no NET traffic
    net = sum(e.net_messages for e in s.engine_stats)
    assert (net > 0) == (wl in ("merge", "sort", "rsum", "rstats"))
    if ref_mem is not None:
        for eng, want in zip(s.engines, ref_mem):
            assert np.array_equal(
                eng.memory[:, 0].numpy().view(np.uint64), want)


@pytest.fixture(scope="module")
def two_party_reference():
    """The JAX package's two-party merge on its batched loop."""
    return reference_two_party_links("merge", "batched", **TWO_PARTY)


@pytest.mark.parametrize("backend", ["batched", "overlap"])
def test_two_party_merge_matches_reference(two_party_reference, backend):
    """The batched and the overlap loop make the reference's batched AND
    calls: one table message a call, the same gate ids and so the same
    table stream on each party link (the scalar loop makes its own calls:
    ``test_torch_workers_scalar.py``)."""
    s = assert_workers_match(two_party_reference, "merge", backend,
                             **TWO_PARTY)
    ref_digests = two_party_reference[2]
    assert s.table_digest == hashlib.sha256(
        (ref_digests[0, 2] + ref_digests[1, 3]).encode()).hexdigest()
    assert all(st.swap_ins > 0 and st.net_messages > 0
               for st in s.engine_stats)
    assert (sum(st.posted_recvs for st in s.engine_stats) > 0) == \
        (backend == "overlap")


@pytest.mark.parametrize("wl,n,budget", [("merge", 256, 6),
                                         ("rstats", 16, 4)])
def test_parallel_plan_modes_give_the_same_plans(wl, n, budget):
    plans, swaps = {}, {}
    for mode in ("serial", "thread", "process"):
        s = Session(JobSpec(wl, n=n, num_workers=2, memory_budget=budget,
                            prefetch_pages=1, parallel_plan=mode),
                    device="cpu")
        plans[mode] = [encode_chunk(p.instrs) for p in s.plan()]
        swaps[mode] = [(r.replacement.swap_ins, r.replacement.swap_outs)
                       for r in s.plan_reports]
    assert len(plans["serial"]) == 2 and swaps["serial"][0][0] > 0
    for mode in ("thread", "process"):
        assert swaps[mode] == swaps["serial"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(plans[mode], plans["serial"]))
    with pytest.raises(ValueError, match="parallel_plan"):
        JobSpec(wl, num_workers=2, memory_budget=4, parallel_plan="fork")


@pytest.mark.parametrize("loop", ["scalar", "overlap"])
def test_net_directives_without_a_worker_link_raise(loop):
    """Nothing falls back: a program with NET_* directives needs a worker
    link, as in the JAX package's engine."""
    s = Session(JobSpec("merge", n=256, num_workers=2,
                        plan_mode="unbounded"), device="cpu")
    prog = s.trace()[0]
    sched = build_overlap_schedule(prog) if loop == "overlap" else None
    eng = Engine(prog, PlaintextDriver(s.workload.inputs(256, 0, 2)), "cpu",
                 overlap_schedule=sched)
    with pytest.raises(TransportError, match="no worker link"):
        eng.run()


def test_four_workers_overlap_from_the_api_and_the_cli(capsys):
    s = Session(JobSpec("rsum", n=64, num_workers=4, memory_budget=3,
                        prefetch_pages=1, exec_backend="overlap"),
                device="cpu")
    s.execute(check=True)
    assert [e.posted_recvs for e in s.engine_stats] == [3, 0, 0, 0]
    assert s.transport_stats and all(k[1] == 0 for k in s.transport_stats)
    argv = ["exec", "--workload", "merge", "-n", "256", "--workers", "4",
            "--budget", "0.4", "--prefetch", "16", "--exec-backend",
            "overlap", "--check", "--device", "cpu"]
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    assert '"num_workers": 4' in text and '"checked": true' in text
    assert '"0->1": [' in text
