"""sort at n = 64 (two local bitonic sorts and a merge stage), two-party on
the CPU on the scalar loop, against the JAX package's Session: outputs
(checked against the oracle), AND gates and garbled-table messages and
bytes must be equal.  A file of its own: the reference takes about a
minute a run here."""

from _torch_gc_jobs import assert_two_party_matches


def test_sort_scalar_two_party_matches_reference():
    assert_two_party_matches("sort", "scalar")
