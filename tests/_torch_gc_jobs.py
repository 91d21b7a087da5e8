"""Shared by the port's GC workload tests (``test_torch_gc_*.py``): one job
run by the JAX package's Session and by the port's on the CPU, compared
exactly — two-party (outputs, AND gates, garbled-table messages and bytes)
or in the clear (outputs and the final engine memory)."""

import numpy as np

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
