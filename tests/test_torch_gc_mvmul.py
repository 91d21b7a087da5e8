"""mvmul at n = 32 (8-bit matrix-vector: MAC8 cells, one at a time on either loop), two-party on the CPU on the batched and the scalar loop, against
the JAX package's Session: outputs (checked against the oracle), AND gates
and garbled-table messages and bytes must be equal.  A file of its own:
the reference takes about a minute a run here."""

import pytest

from _torch_gc_jobs import assert_two_party_matches


@pytest.mark.parametrize("backend", ["batched", "scalar"])
def test_mvmul_two_party_matches_reference(backend):
    assert_two_party_matches("mvmul", backend)
