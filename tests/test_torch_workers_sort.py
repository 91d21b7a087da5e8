"""Two-party sort at p=2 under the JAX package's multi-worker plan
(``tests/test_workloads.py::test_real_two_party_bounded_multiworker``: 10
frames, lookahead 30, 2 prefetch pages), in the port and in the JAX
package, on the batched loop (a file of its own for time: the reference's
run takes minutes on a CPU).  n = 64, one chunk a worker: the
distributed bitonic sort's local sort, then its remote stage, which
exchanges the chunks between the workers; the reference's own test
sorts 128, whose two-party run takes twice as long again.  Outputs,
AND counts, the messages and bytes of every link and the table digest
of each party link must equal the reference's."""

from _torch_gc_jobs import assert_workers_match, reference_two_party_links

SORT = dict(n=64, num_workers=2, memory_budget=10, lookahead=30,
            prefetch_pages=2)


def test_two_party_sort_matches_reference():
    ref = reference_two_party_links("sort", "batched", **SORT)
    s = assert_workers_match(ref, "sort", "batched", **SORT)
    # both workers' working sets fit the 10 frames: no swap, as in the
    # JAX package's test; the remote stage exchanges the chunks
    assert all(st.net_messages > 0 for st in s.engine_stats)
