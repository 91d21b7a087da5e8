"""The port's ``aggsum`` workload against the JAX package's on the CPU.

* ``build_aggsum_records`` equals the reference's and the port's own DSL
  trace (FREE-stripped) for n in {1, 2, 3, 64, 257}; the streamed program
  file has the reference's records digest and header fields.
* The workload executes against its oracle unbounded and at a swapping
  budget, in the clear (equal to the reference's plaintext run) and
  two-party (every AND call through the half gates' plain versions; the
  reference's AND count), and its sum equals the aggregation subsystem's
  ``expected_sum``.
"""

import hashlib

import numpy as np
import pytest

from repro.api import JobSpec as RefJobSpec, Session as RefSession
from repro.core.liveness import file_digest as ref_file_digest
from repro.workloads.agg_workload import (
    build_aggsum_records as ref_records,
    write_aggsum_program as ref_write)
from repro_torch.aggregate import AggSpec, expected_sum
from repro_torch.api import JobSpec, run_job
from repro_torch.core.bytecode import Op, encode_chunk, strip_frees
from repro_torch.core.liveness import file_digest
from repro_torch.workloads import get
from repro_torch.workloads.agg_workload import (AGG_VEC,
                                                build_aggsum_records,
                                                write_aggsum_program)
from repro_torch.workloads.gc_workloads import OUT_TAGS

from _torch_gc_jobs import assert_two_party_matches, same_outputs


@pytest.mark.parametrize("n", [1, 2, 3, 64, 257])
def test_records_are_the_references_and_the_dsl(n):
    fast = build_aggsum_records(n)
    dsl = encode_chunk(strip_frees(get("aggsum").trace(n)[0].instrs))
    want = ref_records(n)
    assert fast.shape == want.shape == (2 * n, want.shape[1])
    assert np.array_equal(fast, want) and np.array_equal(dsl, want)
    assert hashlib.sha256(fast.tobytes()).digest() == \
        hashlib.sha256(want.tobytes()).digest()
    assert set((fast[:, 0] & 0xFFFF).tolist()) <= {
        int(Op.INPUT), int(Op.ADD), int(Op.OUTPUT)}


def test_streamed_file_has_the_references_digest(tmp_path):
    n = 12
    pf = write_aggsum_program(tmp_path / "port.bc", n)
    ref = ref_write(tmp_path / "ref.bc", n)
    assert file_digest(pf) == ref_file_digest(ref)
    assert (tmp_path / "port.bc").read_bytes() == \
        (tmp_path / "ref.bc").read_bytes()
    assert list(pf.iter_instrs()) == \
        strip_frees(get("aggsum").trace(n)[0].instrs)
    assert pf.vspace_slots == get("aggsum").trace(n)[0].vspace_slots
    assert pf.meta["workload"] == "aggsum"
    with pytest.raises(ValueError):
        build_aggsum_records(0)
    counts = get("aggsum").trace(8)[0].op_counts()
    assert (counts["INPUT"], counts["ADD"], counts["OUTPUT"]) == (8, 7, 1)


@pytest.mark.parametrize("job", [dict(plan_mode="unbounded"),
                                 dict(memory_budget=4)],
                         ids=["unbounded", "budget4"])
def test_executes_in_the_clear_as_the_reference(job):
    n = 16
    out = run_job(JobSpec("aggsum", n=n, **job), real=False, check=True,
                  device="cpu")
    ref = RefSession(RefJobSpec(workload="aggsum", n=n, **job)).execute(
        check=True)
    assert same_outputs(out, ref)
    assert out[OUT_TAGS].shape == (AGG_VEC,)
    assert np.array_equal(out[OUT_TAGS],
                          expected_sum(AggSpec(clients=n, vec_len=AGG_VEC),
                                       0))


@pytest.mark.parametrize("backend", ["batched", "overlap"])
def test_executes_two_party_as_the_reference(backend):
    """Two-party at a swapping budget: outputs, AND gates and garbled-table
    traffic equal the reference's (63 ANDs a 64-bit lane an ADD)."""
    s = assert_two_party_matches("aggsum", backend, n=5, memory_budget=4)
    assert s.gate_counts[0].ands == 4 * 63 * AGG_VEC
    engine = s.engine_stats[0]
    assert engine.swap_ins + engine.swap_outs > 0
