"""passreuse at n = 64 (a 64-bit-key merge, sub-span COPYs, batched CMP_EQ and a masking AND), two-party on the CPU on the batched and the scalar loop, against
the JAX package's Session: outputs (checked against the oracle), AND gates
and garbled-table messages and bytes must be equal.  A file of its own:
the reference takes about a minute a run here."""

import pytest

from _torch_gc_jobs import assert_two_party_matches


@pytest.mark.parametrize("backend", ["batched", "scalar"])
def test_passreuse_two_party_matches_reference(backend):
    assert_two_party_matches("passreuse", backend)
