"""Shared by the port's GC workload tests (``test_torch_gc_*.py``,
``test_torch_workers*.py``): one job run by the JAX package's Session and
by the port's on the CPU, compared exactly — two-party (outputs, AND
gates, garbled-table messages and bytes; with several workers, per party
link with its table digest) or in the clear (outputs and the final engine
memory)."""

import hashlib

import numpy as np
import pytest

import repro.core.transport as ref_transport
from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core.engine import Engine as RefEngine
from repro.exec import make_batched as ref_make_batched
from repro.exec.batching import build_batch_schedule as ref_batch_schedule
from repro.protocols.garbled.driver import PlaintextDriver as RefPlaintext
from repro_torch.api import JobSpec, Session

TAB = 1          # the garbled-table tag of the party channel, in both packages

#: each workload's test size and a plan at frames / prefetch pages that
#: swaps where the working set allows (sort and pir at these sizes touch
#: their whole working set in one instruction)
JOBS = {"merge": (64, 5, 1), "sort": (64, 5, 1), "ljoin": (16, 5, 1), "mvmul": (32, 4, 1),
        "binfclayer": (128, 4, 1), "passreuse": (64, 5, 1),
        "pir": (64, 4, 1)}


def job(wl: str) -> dict:
    n, frames, prefetch = JOBS[wl]
    return dict(n=n, memory_budget=frames, prefetch_pages=prefetch)


def tables(stats) -> tuple[int, int]:
    msgs = sum(v.messages for k, v in stats.items() if k[2] == TAB)
    return msgs, sum(v.bytes for k, v in stats.items() if k[2] == TAB)


def same_outputs(out: dict, want: dict) -> bool:
    return sorted(out) == sorted(want) and \
        all(np.array_equal(out[k], want[k]) for k in want)


def assert_two_party_matches(wl: str, backend: str, ref_workload=None,
                             port_workload=None, check: bool = True,
                             **spec) -> Session:
    """Run ``wl`` two-party on ``backend`` in both packages; outputs, AND
    gates and garbled-table traffic must be equal."""
    spec = spec or job(wl)
    ref = RefSession(RefJobSpec(workload=wl, driver="gc-2party",
                                exec_backend=backend, **spec),
                     workload=ref_workload)
    ref_out = ref.execute(check=check)
    port = Session(JobSpec(wl, exec_backend=backend, **spec), device="cpu",
                   workload=port_workload)
    out = port.execute(real=True, check=check)
    assert same_outputs(out, ref_out)
    ref_msgs, ref_bytes = tables(ref.transport_stats)
    g, e = port.gate_counts
    assert g.ands == e.ands == ref_bytes // 32 > 0
    assert tables(port.transport_stats) == (ref_msgs, ref_bytes)
    return port


def reference_plaintext(wl: str, backend: str, ref_workload=None, **spec
                        ) -> tuple[dict, np.ndarray]:
    """The JAX package's gc-plaintext run of the planned job: its outputs
    and its engine's final memory (uint64 slots)."""
    spec = spec or job(wl)
    ref = RefSession(RefJobSpec(workload=wl, driver="gc-plaintext",
                                exec_backend=backend, **spec),
                     workload=ref_workload)
    prog = ref.plan()[0]
    drv = RefPlaintext(ref.workload.inputs(spec["n"], 0, 1))
    sched = None
    if backend == "batched":
        drv, sched = ref_make_batched(drv), ref_batch_schedule(prog)
    eng = RefEngine(prog, drv, batch_schedule=sched)
    eng.run()
    return drv.outputs, eng.memory[:, 0]


def assert_plaintext_matches(wl: str, backend: str, ref_workload=None,
                             port_workload=None, check: bool = True,
                             **spec) -> Session:
    """The port's plaintext run equals the JAX package's: outputs, and the
    final engine memory bit for bit."""
    spec = spec or job(wl)
    ref_out, ref_mem = reference_plaintext(wl, backend, ref_workload, **spec)
    port = Session(JobSpec(wl, exec_backend=backend, **spec), device="cpu",
                   workload=port_workload)
    out = port.execute(real=False, check=check)
    assert same_outputs(out, ref_out)
    mem = port.engines[0].memory[:, 0].numpy().view(np.uint64)
    assert np.array_equal(mem, ref_mem)
    return port


def party_tables(stats, p: int) -> dict:
    """Garbled-table (messages, bytes) per party link: garbler rank k to
    evaluator rank p + k (a worker link may carry tag 1 too: the first
    fresh NET tag)."""
    out = {}
    for (src, dst, tag), v in stats.items():
        if tag == TAB and dst == src + p:
            m = out.setdefault((src, dst), [0, 0])
            m[0] += v.messages
            m[1] += v.bytes
    return out


def reference_two_party_links(wl: str, backend: str, **spec):
    """The JAX package's two-party run of ``wl`` at ``spec``'s workers,
    with the garbled-table stream hashed per party link (a wrapper around
    its transport's send; its code is unchanged).  Returns the outputs,
    the transport's stats and the digests by (garbler, evaluator) rank."""
    p = spec.get("num_workers", 1)
    digests: dict = {}
    send = ref_transport.InprocTransport.send

    def hashing_send(self, src, dst, tag, data, copy=True):
        if tag == TAB and dst == src + p:
            digests.setdefault((src, dst), hashlib.sha256()).update(
                np.ascontiguousarray(data).tobytes())
        return send(self, src, dst, tag, data, copy)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_transport.InprocTransport, "send", hashing_send)
        ref = RefSession(RefJobSpec(workload=wl, driver="gc-2party",
                                    exec_backend=backend, **spec))
        out = ref.execute(check=True)
    return out, ref.transport_stats, {k: h.hexdigest()
                                      for k, h in digests.items()}


def assert_workers_match(reference, wl: str, backend: str, **spec
                         ) -> Session:
    """Run ``wl`` two-party in the port on ``backend`` and hold it to
    ``reference`` (``reference_two_party_links`` of a loop that makes the
    same AND calls): outputs, AND counts, every message and byte of every
    link (worker links and party links) and each party link's table
    digest."""
    ref_out, ref_stats, ref_digests = reference
    p = spec.get("num_workers", 1)
    s = Session(JobSpec(wl, exec_backend=backend, **spec), device="cpu")
    out = s.execute(real=True, check=True, digest=True)
    assert same_outputs(out, ref_out)
    tables = party_tables(s.transport_stats, p)
    assert sorted(tables) == [(k, p + k) for k in range(p)]
    assert tables == party_tables(ref_stats, p)
    g, e = s.gate_counts
    assert g.ands == e.ands == sum(b for _, b in tables.values()) // 32 > 0
    assert {k: (v.messages, v.bytes) for k, v in
            s.transport_stats.items()} == \
        {k: (v.messages, v.bytes) for k, v in ref_stats.items()}
    assert s.table_digests == ref_digests
    return s
