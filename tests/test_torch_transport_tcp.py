"""The port's TCP and shaped transports and its fabric, against the JAX
package's on the CPU (``tests/test_transport.py`` holds the reference).

* The wire: frames byte for byte the reference's, a round trip with
  reordered tags in every dtype the port sends (int64 labels and tables,
  int32, uint8 decode bits, float64, zero-length barrier tokens), landing
  on the transport's device and in ``out``; the barrier, ``close`` waking
  a receiver, a link born closed after its peer hung up, and sending as
  another rank refused.
* The baton: co-hosted TCP ranks over a depth-bounded link with far more
  than the party channel's ``DEPTH`` messages ahead, and sockets full, end
  without deadlock, each engine thread holding the baton whenever it runs.
* Shaping: ``shaped`` and ``shaped+tcp`` delay delivery and carry the
  bytes ``inproc`` does.
* Specs: ``build_fabric``'s validation and the ``FabricSpec`` JSON round
  trip, outside the plan hash as in the reference.
* Jobs over TCP in one process: merge in the clear at two workers equals
  the inproc run and the reference's (outputs, per-(src, dst, tag) stats,
  the engines' NET stats); two-party GC equals inproc and the reference's
  TCP run (outputs, AND counts, table digest, per-tag stats); CKKS rsum at
  two workers equals inproc with every engine's final memory.
"""

import hashlib
import json
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.core.transport as ref_transport
from repro.api import (FabricSpec as RefFabricSpec, JobSpec as RefJobSpec,
                       Session as RefSession)
from repro_torch.api import JobSpec, Session
from repro_torch.core import transport as tp
from repro_torch.core.transport import (FabricSpec, InprocTransport,
                                        LinkShape, ShapedTransport,
                                        TcpTransport, TransportError,
                                        build_fabric, pick_free_ports)
from repro_torch.protocols.garbled.gates import PartyChannel

from _torch_gc_jobs import TAB, same_outputs

TIMEOUT = 20.0


def _peers(n: int) -> tuple[str, ...]:
    return tuple(f"127.0.0.1:{p}" for p in pick_free_ports(n))


def _tcp_fabric(n: int = 2, name: str = "tcp", **spec):
    fx = build_fabric(name, n, FabricSpec(peers=_peers(n), **spec))
    fx.connect()
    return fx


def _threads(fns, baton=None, timeout=30.0) -> list:
    """Run each fn on its own thread (holding ``baton`` if given)."""
    out = [None] * len(fns)
    errors = []

    def body(k, fn):
        try:
            if baton is None:
                out[k] = fn()
            else:
                with baton:
                    out[k] = fn()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(k, fn), daemon=True)
               for k, fn in enumerate(fns)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    assert not any(th.is_alive() for th in threads), "threads hung"
    if errors:
        raise errors[0]
    return out


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arr", [
    np.arange(8, dtype=np.int64).reshape(4, 2),
    np.array([7, 9], dtype=np.uint8),
    np.array([1.5, -2.0]),
    np.zeros(0, dtype=np.uint8),
    np.arange(6, dtype=np.int32).reshape(1, 2, 3)],
    ids=["int64", "uint8", "float64", "empty", "int32-3d"])
def test_frames_are_the_references(arr):
    """A data frame is byte for byte the reference's, and a frame from
    either side decodes to the same array on the other."""
    frame = tp._frame_head(3, 1, 42, arr) + arr.tobytes()
    assert frame == ref_transport._pack_data(3, 1, 42, arr)
    src, dst, tag, got = ref_transport._unpack_data(frame[4:])
    assert (src, dst, tag) == (3, 1, 42) and got.dtype == arr.dtype
    assert np.array_equal(got, arr)
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        a.shutdown(socket.SHUT_WR)
        src, dst, tag, got = tp._read_frame(b)
        assert (src, dst, tag) == (3, 1, 42)
        assert got.dtype == arr.dtype and got.shape == arr.shape
        assert np.array_equal(got, arr)
        assert got.ctypes.data % arr.dtype.alignment == 0
        assert tp._read_frame(b) is None            # EOF
    finally:
        a.close()
        b.close()


def test_tcp_roundtrip_reorder_and_dtypes():
    fx = _tcp_fabric()
    a, b = fx.transport_for(0), fx.transport_for(1)
    try:
        assert isinstance(a, TcpTransport) and a.device.type == "cpu"
        labels = torch.arange(8, dtype=torch.int64).reshape(4, 2)
        a.send(0, 1, 5, labels)
        a.send(0, 1, 3, torch.tensor([7, 9], dtype=torch.uint8))
        a.send(0, 1, 6, torch.zeros(0, dtype=torch.int64))
        a.send(0, 1, 7, torch.arange(6, dtype=torch.int32))
        b.send(1, 0, 1, torch.tensor([1.5, -2.0], dtype=torch.float64))
        got3 = b.recv(0, 1, 3, timeout=TIMEOUT)
        assert got3.dtype == torch.uint8 and got3.tolist() == [7, 9]
        out = torch.zeros(2, 4, dtype=torch.int64)
        assert b.recv(0, 1, 5, out=out, timeout=TIMEOUT) is out
        assert torch.equal(out, labels.reshape(2, 4))
        empty = b.recv(0, 1, 6, timeout=TIMEOUT)
        assert empty.shape == (0,) and empty.dtype == torch.int64
        got7 = b.recv(0, 1, 7, timeout=TIMEOUT)
        assert got7.dtype == torch.int32 and got7.device == b.device
        got1 = a.recv(1, 0, 1, timeout=TIMEOUT)
        assert got1.dtype == torch.float64 and got1.tolist() == [1.5, -2.0]
        # send-side accounting in the tensors' bytes, as the reference's
        assert a.stats() == {(0, 1, 5): tp.LinkStats(1, 64),
                             (0, 1, 3): tp.LinkStats(1, 2),
                             (0, 1, 6): tp.LinkStats(1, 0),
                             (0, 1, 7): tp.LinkStats(1, 24)}
        assert fx.link_totals()[(1, 0)] == tp.LinkStats(1, 16)
        with pytest.raises(TransportError, match="cannot send as rank 1"):
            a.send(1, 0, 1, labels)
        with pytest.raises(TransportError, match="cannot recv as rank 1"):
            a.recv(0, 1, 1, timeout=TIMEOUT)
    finally:
        fx.close()


def test_tcp_barrier_and_close_wakes_receiver():
    fx = _tcp_fabric(3)
    ts = [fx.transport_for(r) for r in range(3)]
    try:
        order = []

        def rank(r):
            def fn():
                for epoch in range(2):
                    order.append(("in", epoch))
                    ts[r].barrier(r, range(3), timeout=TIMEOUT)
                    order.append(("out", epoch))
            return fn

        _threads([rank(r) for r in range(3)])
        for epoch in range(2):
            ins = [k for k, e in enumerate(order) if e == ("in", epoch)]
            outs = [k for k, e in enumerate(order) if e == ("out", epoch)]
            assert max(ins) < min(outs)
        assert fx.stats() == {}                     # tokens are plumbing
        fx.barrier()                                # the fleet's barrier
        woken = []

        def wait():
            t0 = time.monotonic()
            try:
                ts[1].recv(0, 1, 99, timeout=30)
            except TransportError:
                woken.append(time.monotonic() - t0)

        waiter = threading.Thread(target=wait, daemon=True)
        waiter.start()
        time.sleep(0.1)
    finally:
        fx.close()
    waiter.join(timeout=TIMEOUT)
    assert not waiter.is_alive() and len(woken) == 1 and woken[0] < 10


def test_tcp_dead_peer_closes_links_created_later():
    """A receive on a link first touched after its peer hung up raises
    instead of waiting (links are made lazily; the dead-peer mark closes
    late ones)."""
    fx = _tcp_fabric()
    a, b = fx.transport_for(0), fx.transport_for(1)
    a.close()
    for t in b._readers:
        t.join(5.0)
    with pytest.raises(tp.TransportClosed):
        b.recv(0, 1, 42, timeout=TIMEOUT)
    b.close()


# ---------------------------------------------------------------------------
# the baton under backpressure
# ---------------------------------------------------------------------------


def test_co_hosted_tcp_backpressure_keeps_the_baton_rule():
    """A garbler-like sender far ahead of its co-hosted receiver: the
    receiver's inbound link holds at most 8 messages, so its reader stops
    draining, the sockets fill and the sender's ``sendall`` blocks, which
    must give the baton up.  The reader never holds the baton, and each
    engine thread holds it whenever it runs.  The interpreter switches
    threads as often as it can."""
    fx = _tcp_fabric()
    a, b = fx.transport_for(0), fx.transport_for(1)
    assert a.baton is b.baton is fx.baton
    n_msgs = 3 * PartyChannel.DEPTH
    b.set_depth(0, 1, max_msgs=8)
    payload = torch.arange(16384, dtype=torch.int64)   # 128 KiB a message
    held = []

    def send():
        for k in range(n_msgs):
            a.send(0, 1, 1, payload + k)
            held.append(fx.baton.held())

    def recv():
        got = []
        for k in range(n_msgs):
            m = b.recv(0, 1, 1, timeout=TIMEOUT)
            held.append(fx.baton.held())
            got.append(int(m[0]) - k)
        return got

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _, got = _threads([send, recv], baton=fx.baton)
    finally:
        sys.setswitchinterval(old)
        fx.close()
    assert got == [0] * n_msgs and all(held) and len(held) == 2 * n_msgs
    assert not fx.baton.locked()
    assert a.stats()[(0, 1, 1)] == tp.LinkStats(n_msgs, n_msgs * 131072)


# ---------------------------------------------------------------------------
# shaping
# ---------------------------------------------------------------------------


def test_shaped_delays_delivery_and_preserves_traffic():
    t = ShapedTransport(InprocTransport(2), LinkShape(latency_s=0.15))
    plain = InprocTransport(2)
    for tr in (t, plain):
        tr.send(0, 1, 1, torch.arange(4, dtype=torch.int64))
    t0 = time.monotonic()
    assert t.recv(0, 1, 1).tolist() == [0, 1, 2, 3]
    assert time.monotonic() - t0 >= 0.10
    assert t.stats() == plain.stats()
    bw = ShapedTransport(InprocTransport(2), LinkShape(bandwidth=1e6))
    t0 = time.monotonic()
    for _ in range(2):          # 2 x 50 KB at 1 MB/s: at least 0.1 s
        bw.send(0, 1, 1, torch.zeros(50_000 // 8, dtype=torch.int64))
    with bw.baton:
        bw.recv(0, 1, 1)
        bw.recv(0, 1, 1)
        assert bw.baton.held()          # the sleeps gave it back
    assert time.monotonic() - t0 >= 0.08


def test_shaped_tcp_paces_the_sender_and_preserves_traffic():
    fx = _tcp_fabric(name="shaped+tcp", latency_s=0.15)
    a, b = fx.transport_for(0), fx.transport_for(1)
    try:
        assert a.paced_send and a.inner.name == "tcp"
        t0 = time.monotonic()
        a.send(0, 1, 4, torch.tensor([1, 2, 3]))
        assert time.monotonic() - t0 >= 0.10       # paced at the sender
        assert b.recv(0, 1, 4, timeout=TIMEOUT).tolist() == [1, 2, 3]
        b.send(1, 0, 9, torch.tensor([2.5], dtype=torch.float64))
        assert a.recv(1, 0, 9, timeout=TIMEOUT).tolist() == [2.5]
        assert fx.stats() == {(0, 1, 4): tp.LinkStats(1, 24),
                              (1, 0, 9): tp.LinkStats(1, 8)}
    finally:
        fx.close()


# ---------------------------------------------------------------------------
# specs and validation
# ---------------------------------------------------------------------------


def test_build_fabric_validation():
    with pytest.raises(KeyError, match="unknown transport"):
        build_fabric("bogus", 2)
    with pytest.raises(TransportError, match="peer addresses"):
        build_fabric("tcp", 2, FabricSpec(peers=("h:1",)))
    with pytest.raises(TransportError, match="single rank"):
        build_fabric("inproc", 2, FabricSpec(rank=0))
    with pytest.raises(TransportError, match="same-process"):
        build_fabric("shaped", 2, FabricSpec(rank=0, peers=("h:1", "h:2")))
    with pytest.raises(TransportError, match="outside"):
        build_fabric("tcp", 2, FabricSpec(rank=2, peers=("h:1", "h:2")))
    with pytest.raises(TransportError, match="bad peer address"):
        build_fabric("tcp", 2, FabricSpec(rank=0, peers=("h1", "h:2")))
    fx = build_fabric("inproc", 4)
    assert not fx.distributed and fx.hosted == [0, 1, 2, 3]
    assert fx.transport_for(0) is fx.transport_for(3)
    fx = build_fabric("tcp", 2, FabricSpec(rank=1, peers=("h:1", "h:2")))
    assert fx.distributed and fx.hosted == [1]
    with pytest.raises(TransportError, match="not hosted"):
        fx.transport_for(0)
    fx = build_fabric("shaped+tcp", 2, FabricSpec(rank=1, peers=("h:1",
                                                                 "h:2"),
                                                  latency_s=0.01))
    assert fx.distributed and fx.transport_for(1).paced_send
    assert sorted(tp.TRANSPORTS) == sorted(ref_transport.TRANSPORTS)


def test_fabric_spec_json_roundtrip():
    fabric = FabricSpec(rank=1, peers=("a:1", "b:2"), latency_s=0.01)
    spec = JobSpec("merge", n=128, memory_budget=10, transport="tcp",
                   fabric=fabric)
    back = JobSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert back == spec and back.fabric == fabric
    # placement never changes the plan's identity, in either package
    want = RefJobSpec(workload="merge", n=128, memory_budget=10,
                      transport="tcp",
                      fabric=RefFabricSpec(rank=1, peers=("a:1", "b:2"))
                      ).plan_hash()
    assert back.plan_hash() == JobSpec("merge", n=128,
                                       memory_budget=10).plan_hash() == want


# ---------------------------------------------------------------------------
# jobs over TCP, all ranks in this process
# ---------------------------------------------------------------------------

CLEAR = dict(n=128, num_workers=2, memory_budget=10, lookahead=40,
             prefetch_pages=2)


def _net(stats) -> list:
    return [(e.net_messages, e.net_sent_bytes, e.net_recv_bytes,
             e.net_links) for e in stats]


def _by_tag(stats) -> dict:
    return {k: (v.messages, v.bytes) for k, v in stats.items()}


def test_merge_identical_over_inproc_and_tcp():
    runs = {}
    for transport in ("inproc", "tcp"):
        fabric = FabricSpec(peers=_peers(2)) if transport == "tcp" else None
        s = Session(JobSpec("merge", transport=transport, fabric=fabric,
                            **CLEAR), device="cpu")
        runs[transport] = (s.execute(real=False, check=True), s)
    (out_a, a), (out_b, b) = runs["inproc"], runs["tcp"]
    assert same_outputs(out_b, out_a)
    assert _net(a.engine_stats) == _net(b.engine_stats)
    assert _by_tag(a.transport_stats) == _by_tag(b.transport_stats)
    sent = sum(e.net_sent_bytes for e in a.engine_stats)
    assert sent == sum(v.bytes for v in a.transport_stats.values()) > 0
    ref = RefSession(RefJobSpec(workload="merge", exec_backend="batched",
                                **CLEAR))
    assert same_outputs(out_a, ref.execute(check=True))
    assert _by_tag(ref.transport_stats) == _by_tag(b.transport_stats)


@pytest.fixture(scope="module")
def reference_tcp_gc():
    """The reference's two-party merge over its TCP fabric (batched loop,
    so its table messages are the port's), with the table stream hashed
    (a wrapper around its TCP transport's send; its code is unchanged)."""
    h = hashlib.sha256()
    send = ref_transport.TcpTransport.send

    def hashing_send(self, src, dst, tag, data, copy=True):
        if tag == TAB and (src, dst) == (0, 1):
            h.update(np.ascontiguousarray(data).tobytes())
        return send(self, src, dst, tag, data, copy)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_transport.TcpTransport, "send", hashing_send)
        ref = RefSession(RefJobSpec(
            workload="merge", n=32, plan_mode="unbounded",
            driver="gc-2party", exec_backend="batched", transport="tcp",
            fabric=RefFabricSpec(peers=_peers(2))))
        out = ref.execute(check=True)
    return out, ref.transport_stats, h.hexdigest()


def test_two_party_gc_over_tcp_matches_inproc_and_reference(
        reference_tcp_gc):
    ref_out, ref_stats, ref_digest = reference_tcp_gc
    runs = {}
    for transport in ("inproc", "tcp"):
        fabric = FabricSpec(peers=_peers(2)) if transport == "tcp" else None
        s = Session(JobSpec("merge", n=32, plan_mode="unbounded",
                            transport=transport, fabric=fabric),
                    device="cpu")
        runs[transport] = (s.execute(real=True, check=True, digest=True), s)
    for out, s in runs.values():
        assert same_outputs(out, ref_out)
        g, e = s.gate_counts
        assert g.ands == e.ands == ref_stats[(0, 1, TAB)].bytes // 32 > 0
        assert s.table_digest == s.table_digests[(0, 1)] == ref_digest
        assert _by_tag(s.transport_stats) == _by_tag(ref_stats)
    # every protocol kind crossed the garbler -> evaluator link
    assert {1, 3, 4, 5} <= {t for (a, b, t) in
                            runs["tcp"][1].transport_stats if (a, b) ==
                            (0, 1)}


def test_ckks_over_tcp_matches_inproc():
    spec = dict(n=32, num_workers=2, memory_budget=4, prefetch_pages=1,
                ckks_ring=128)
    runs = {}
    for transport in ("inproc", "tcp"):
        fabric = FabricSpec(peers=_peers(2)) if transport == "tcp" else None
        s = Session(JobSpec("rsum", transport=transport, fabric=fabric,
                            **spec), device="cpu")
        runs[transport] = (s.execute(check=True), s)
    (out_a, a), (out_b, b) = runs["inproc"], runs["tcp"]
    assert sorted(out_a) == sorted(out_b)
    assert all(np.array_equal(out_a[k], out_b[k]) for k in out_a)
    for ea, eb in zip(a.engines, b.engines):
        assert torch.equal(ea.memory, eb.memory)
    assert _by_tag(a.transport_stats) == _by_tag(b.transport_stats) != {}
