"""Two-party merge n=64 at p=2 on the scalar loop, in the port and in the
JAX package (a file of its own for time: the reference's two-party run
takes a minute or more on a CPU).  The scalar loop makes one AND call an
instruction, so its gate ids, and with them the table stream, differ from
the batched loop's; each is held to the reference's run of the same
loop: outputs, AND counts, the messages and bytes of every link and the
table digest of each party link."""

from _torch_gc_jobs import assert_workers_match, reference_two_party_links

#: the job of test_torch_workers.py's two-party test
TWO_PARTY = dict(n=64, num_workers=2, memory_budget=5, prefetch_pages=1)


def test_two_party_merge_scalar_matches_reference():
    ref = reference_two_party_links("merge", "scalar", **TWO_PARTY)
    s = assert_workers_match(ref, "merge", "scalar", **TWO_PARTY)
    assert all(st.batches == 0 and st.net_messages > 0
               for st in s.engine_stats)
