"""The port's in-process transport for multi-worker jobs: per-tag reorder
buffers, ``recv(out=)``, the send snapshot, the token barrier, deferred
receives (``recv_async``), ``PartyView`` and the per-link totals.  Every
thread that may wait holds the transport's baton, as engine threads do."""

import sys
import threading

import pytest
import torch

from repro_torch.core.transport import (Completion, InprocTransport,
                                        LinkStats, PartyView, TransportClosed,
                                        TransportError, aggregate_links)


def _run_threads(t: InprocTransport, fns) -> list:
    """Run each fn on its own thread holding the baton; return results."""
    out = [None] * len(fns)
    errors = []

    def body(k, fn):
        try:
            with t.baton:
                out[k] = fn()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(k, fn))
               for k, fn in enumerate(fns)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    if errors:
        raise errors[0]
    return out


def test_out_of_order_tags_buffer():
    t = InprocTransport(2)
    t.send(0, 1, 2, torch.tensor([20]))
    t.send(0, 1, 1, torch.tensor([10]))
    assert int(t.recv(0, 1, 1)[0]) == 10
    assert int(t.recv(0, 1, 2)[0]) == 20


def test_per_tag_fifo():
    t = InprocTransport(3)
    for k in range(4):
        t.send(2, 0, 7, torch.tensor([k]))
        t.send(2, 0, 8, torch.tensor([100 + k]))
    assert [int(t.recv(2, 0, 8)[0]) for _ in range(4)] == [100, 101, 102,
                                                           103]
    assert [int(t.recv(2, 0, 7)[0]) for _ in range(4)] == [0, 1, 2, 3]


def test_recv_out_reshapes():
    t = InprocTransport(2)
    t.send(1, 0, 3, torch.arange(6, dtype=torch.int64))
    out = torch.zeros((3, 2), dtype=torch.int64)
    got = t.recv(1, 0, 3, out=out)
    assert torch.equal(out, torch.arange(6).reshape(3, 2))
    assert got.shape == (6,)


def test_sent_view_overwritten_afterwards_arrives_as_sent():
    """``send`` snapshots the tensor: a NET_SEND of an engine-memory view
    whose span the sender reuses before the peer reads it must still
    deliver what was sent.  ``copy=False`` hands the tensor over as it is
    (the party channel's fresh tables), so the overwrite shows there."""
    t = InprocTransport(2)
    memory = torch.arange(8, dtype=torch.int64).reshape(4, 2)
    t.send(0, 1, 1, memory[1:3])
    t.send(0, 1, 2, memory[1:3], copy=False)
    memory[1:3] = -1
    assert torch.equal(t.recv(0, 1, 1), torch.tensor([[2, 3], [4, 5]]))
    assert torch.equal(t.recv(0, 1, 2), torch.full((2, 2), -1))
    assert t.stats()[(0, 1, 1)].bytes == 4 * 8


def test_barrier_over_four_ranks():
    """No rank leaves a barrier before every rank has entered it, twice in
    a row (a barrier's epoch picks its tag); the tokens stay out of the
    traffic counts."""
    t = InprocTransport(4)
    log = []

    def rank(r):
        def fn():
            for epoch in range(2):
                log.append(("in", epoch, r))
                t.barrier(r, range(4), timeout=10)
                log.append(("out", epoch, r))
        return fn

    _run_threads(t, [rank(r) for r in range(4)])
    for epoch in range(2):
        ins = [k for k, e in enumerate(log) if e[:2] == ("in", epoch)]
        outs = [k for k, e in enumerate(log) if e[:2] == ("out", epoch)]
        assert len(ins) == len(outs) == 4 and max(ins) < min(outs)
    assert t.stats() == {}
    view = PartyView(t, 0, 4)
    _run_threads(t, [lambda r=r: view.barrier(r) for r in range(4)])


def test_recv_async_consumes_nothing_before_wait():
    t = InprocTransport(2)
    t.send(0, 1, 5, torch.tensor([1]))
    out = torch.zeros(1, dtype=torch.int64)
    h = t.recv_async(0, 1, 5, out=out)
    assert not h.done() and int(out[0]) == 0
    # the message is still in the buffer: a plain receive takes it
    assert int(t.recv(0, 1, 5)[0]) == 1
    t.send(0, 1, 5, torch.tensor([2]))
    assert int(h.wait()[0]) == 2 and int(out[0]) == 2 and h.done()
    assert int(h.wait()[0]) == 2                  # idempotent
    assert Completion.completed().done()
    assert t.send_async(0, 1, 6, torch.tensor([3])).done()
    assert int(t.recv(0, 1, 6)[0]) == 3


def test_closed_link_wakes_deferred_receive():
    t = InprocTransport(2)
    h = t.recv_async(0, 1, 9)
    threading.Timer(0.05, t.close).start()
    with pytest.raises(TransportClosed):
        _run_threads(t, [h.wait])
    assert not t.baton.locked()
    # a link made after the close starts closed
    with pytest.raises(TransportClosed):
        t.recv(1, 0, 9)


def test_party_view_offsets_ranks_and_bounds_receives():
    t = InprocTransport(4)
    view = PartyView(t, 2, 2, recv_timeout=0.05)
    view.send(0, 1, 4, torch.tensor([7]))
    assert (2, 3, 4) in t.stats()
    out = torch.zeros(1, dtype=torch.int64)
    view.recv(0, 1, 4, out=out)
    assert int(out[0]) == 7
    with t.baton, pytest.raises(TransportError,
                                match="NET_RECV worker1->worker0 tag=4"):
        view.recv(1, 0, 4)
    h = view.recv_async(1, 0, 5)
    with t.baton, pytest.raises(TransportError,
                                match="NET_RECV worker1->worker0 tag=5"):
        h.wait()
    assert PartyView(t, 0, 2).recv_timeout == PartyView.RECV_TIMEOUT_S


def test_link_totals_aggregate_tags():
    t = InprocTransport(3)
    t.send(0, 1, 1, torch.zeros(4, dtype=torch.int64))
    t.send(0, 1, 2, torch.zeros(2, dtype=torch.int64))
    t.send(2, 1, 1, torch.zeros(1, dtype=torch.int32))
    want = {(0, 1): LinkStats(2, 48), (2, 1): LinkStats(1, 4)}
    assert t.link_totals() == want == aggregate_links(t.stats())


def test_many_senders_lose_no_message_or_count():
    """Sixteen sender threads (more than the cores) that hold no baton (a
    send on a link without a depth bound never waits), one receiver, the
    interpreter switching threads as often as it can: every message
    arrives in its tag's order and the traffic counts lose no update."""
    senders, per = 16, 50
    t = InprocTransport(senders + 1)
    got = {}

    def send(src):
        for k in range(per):
            t.send(src, senders, src, torch.tensor([k]))

    def recv():
        for src in range(senders):
            got[src] = [int(t.recv(src, senders, src, timeout=10)[0])
                        for _ in range(per)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=send, args=(s,))
                   for s in range(senders)]
        for th in threads:
            th.start()
        _run_threads(t, [recv])
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert got == {s: list(range(per)) for s in range(senders)}
    totals = t.link_totals()
    assert all(totals[s, senders] == LinkStats(per, per * 8)
               for s in range(senders))
