"""The transport fabric for every message between engines: the port's copy
of ``repro.core.transport``.  Messages are tensors.

One fabric carries both kinds of traffic: the intra-party NET_*
directives of multi-worker jobs (worker links, addressed through a
:class:`PartyView`) and the garbled-circuit party stream (garbler worker
k to evaluator worker k, ``protocols.garbled.gates.PartyChannel``).  Rank
space: a fabric with P parties of W workers has ``P * W`` endpoints,
``rank = party * W + worker``.  Every backend is a :class:`Transport`:

* ``inproc``: all endpoints in this process, per-link reorder buffers.
* ``tcp``: one endpoint a :class:`TcpTransport`, length-prefixed frames
  over sockets (the reference's framing), one outbound connection a peer
  and a reader thread an inbound one, which decodes each frame into a
  host tensor and puts it on the link.  ``send`` stages a device tensor
  through host memory; ``recv`` hands back a tensor on the transport's
  device (or copies into ``out``).
* ``shaped``: latency and bandwidth on every link of another transport
  (:class:`ShapedTransport`); ``shaped+tcp`` paces the sender instead,
  so it works across processes.

A :class:`FabricSpec` places endpoints: ``rank=None`` hosts every
endpoint in this process, ``rank=k`` hosts only endpoint k and reaches the
others at ``peers``.  :func:`build_fabric` builds a :class:`Fabric` of the
hosted endpoints' transports from the ``TRANSPORTS`` registry.

Each (src, dst) link keeps a per-tag FIFO: distinct tags buffer
independently, so out-of-order tags match instead of raising.  A link may
bound its pending set (``set_depth``) so that a producer running ahead
blocks instead of materializing the whole garbled circuit (§2.4.2); over
TCP the bound stops the reader, which pushes back through TCP flow
control.  A receive may time out, which turns a protocol desync into an
error instead of a hang.  ``send`` snapshots the tensor: in-process a
clone on its device (``copy=True``) unless the sender promises never to
mutate it again (``copy=False``: the party channel's freshly built
tables); over TCP the host copy and the frame are the snapshot.  Every
engine thread launches on its device's current stream, so an in-process
snapshot is ordered before the receiver's ``copy_`` into its memory.

The engine threads of a process take turns: each holds the fabric's
*baton* (:class:`Baton`, one for all the transports a process hosts)
while it runs and gives it up only while it waits, so at most one of them
competes for the interpreter lock.  Two threads that both launch tensor
ops (each of which releases the interpreter lock) would otherwise hand
that lock back and forth on every op, and the handoffs cost far more than
the ops.  Every wait gives the baton up if the waiting thread holds it: a
link wait, a deferred receive's ``Completion.wait``, a barrier's token
receives, a shaped link's delivery sleep and a TCP ``sendall`` that
blocks under backpressure (else a garbler far ahead of its co-hosted
evaluator would hold the baton while the evaluator's reader waits for it
to drain).  A TCP reader thread never holds the baton, so its waits touch
it not at all.
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Iterable, Sequence

import numpy as np
import torch


class TransportError(RuntimeError):
    pass


class TransportClosed(TransportError):
    """The link closed (peer gone) with a receive still outstanding."""


@dataclasses.dataclass
class LinkStats:
    messages: int = 0
    bytes: int = 0


@dataclasses.dataclass
class ReorderStats:
    """One link's reorder-buffer occupancy (receive side): what is pending
    now, the high-water marks since the link was made, and its bounds (0:
    none)."""
    pending_msgs: int = 0
    pending_bytes: int = 0
    peak_msgs: int = 0
    peak_bytes: int = 0
    max_msgs: int = 0
    max_bytes: int = 0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: reserved tag ranges (ordinary tags are small non-negative ints: the DSL's
#: fresh_tag counter and the garbled kind tags): barrier tokens use deeply
#: negative tags, so they never collide with data on the same link
_ENGINE_BARRIER_BASE = -(1 << 40)
_FABRIC_BARRIER_BASE = -(1 << 50)


def aggregate_links(stats: dict[tuple[int, int, int], LinkStats]
                    ) -> dict[tuple[int, int], LinkStats]:
    """(src, dst, tag) stats -> per-(src, dst) link totals."""
    out: dict[tuple[int, int], LinkStats] = {}
    for (src, dst, _tag), s in stats.items():
        t = out.setdefault((src, dst), LinkStats())
        t.messages += s.messages
        t.bytes += s.bytes
    return out


class Baton:
    """The turn-taking lock of the module note.  It knows which thread
    holds it, so a wait gives it up only when the waiting thread holds it
    (an engine thread) and never touches it otherwise (a TCP reader, a
    caller outside the engines)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owner: int | None = None

    def acquire(self) -> None:
        self._lock.acquire()
        self._owner = threading.get_ident()

    def release(self) -> None:
        self._owner = None
        self._lock.release()

    def held(self) -> bool:
        """Whether the calling thread holds the baton."""
        return self._owner == threading.get_ident()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "Baton":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def give_up(self) -> bool:
        """Release the baton if this thread holds it; returns whether it
        did (the caller takes it back with ``acquire``)."""
        if self.held():
            self.release()
            return True
        return False


def _sleep(baton: Baton, seconds: float) -> None:
    """Sleep with the baton given up (a shaped link's delivery time)."""
    if seconds > 0:
        released = baton.give_up()
        try:
            time.sleep(seconds)
        finally:
            if released:
                baton.acquire()


class _Link:
    """One (src, dst) lane: a locked per-tag reorder buffer, bounded by
    ``max_msgs`` pending messages and ``max_bytes`` pending bytes.  A
    ``put`` waits only while the link is already at a bound, so one more
    message always passes: the pending bytes stay under ``max_bytes`` plus
    the largest message the link carries.  ``peak_msgs`` and
    ``peak_bytes`` are the high-water marks.  A blocked ``put`` or ``get``
    gives up the ``baton`` while it waits if the calling thread holds it,
    and takes it back once it has left the link's lock."""

    def __init__(self, baton: Baton, max_msgs: int = 0, max_bytes: int = 0):
        self._cond = threading.Condition()
        self._by_tag: dict[int, deque] = {}
        self._pending = 0
        self._pending_bytes = 0
        self.peak_msgs = 0            # high-water marks: what shows that the
        self.peak_bytes = 0           # bounds held the pending set
        self._baton = baton
        self.max_msgs = max_msgs
        self.max_bytes = max_bytes
        self.closed = False

    def _over(self) -> bool:
        return bool((self.max_msgs and self._pending >= self.max_msgs) or
                    (self.max_bytes and
                     self._pending_bytes >= self.max_bytes))

    def _wait(self, timeout: float | None, released: bool) -> bool:
        """Wait on the link (its lock held); returns whether this call has
        given up the baton."""
        if not released:
            released = self._baton.give_up()
        self._cond.wait(timeout)
        return released

    def put(self, tag: int, data: torch.Tensor) -> None:
        released = False
        try:
            with self._cond:
                while self._over() and not self.closed:
                    released = self._wait(None, released)
                if self.closed:
                    raise TransportClosed("send on closed link")
                self._by_tag.setdefault(tag, deque()).append(data)
                self._pending += 1
                self._pending_bytes += nbytes(data)
                self.peak_msgs = max(self.peak_msgs, self._pending)
                self.peak_bytes = max(self.peak_bytes, self._pending_bytes)
                self._cond.notify_all()
        finally:
            if released:
                self._baton.acquire()

    def set_bounds(self, max_msgs: int, max_bytes: int | None) -> None:
        """Bound the pending set; ``max_bytes=None`` keeps the byte bound."""
        with self._cond:
            self.max_msgs = max_msgs
            if max_bytes is not None:
                self.max_bytes = max_bytes
            self._cond.notify_all()

    def reorder_stats(self) -> ReorderStats:
        with self._cond:
            return ReorderStats(self._pending, self._pending_bytes,
                                self.peak_msgs, self.peak_bytes,
                                self.max_msgs, self.max_bytes)

    def get(self, tag: int, timeout: float | None = None) -> torch.Tensor:
        deadline = None if timeout is None else time.monotonic() + timeout
        released = False
        try:
            with self._cond:
                while True:
                    q = self._by_tag.get(tag)
                    if q:
                        data = q.popleft()
                        if not q:
                            del self._by_tag[tag]
                        self._pending -= 1
                        self._pending_bytes -= nbytes(data)
                        self._cond.notify_all()
                        return data
                    if self.closed:
                        raise TransportClosed(
                            f"link closed with recv(tag={tag}) outstanding")
                    left = None
                    if deadline is not None:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise TransportError(
                                f"recv(tag={tag}) timed out after {timeout}s")
                    released = self._wait(left, released)
        finally:
            if released:
                self._baton.acquire()

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()


class Completion:
    """Handle for an asynchronous transport operation.

    ``send_async`` returns an already-completed handle (sends hand their
    tensor to the link eagerly); ``recv_async`` returns a *deferred*
    receive: the message stays in the link's reorder buffer until
    :meth:`wait` runs the blocking ``recv`` (which gives the baton up
    while it blocks).  Handles of one ``(src, dst, tag)`` channel must be
    waited in the order they were made: per-tag FIFO is resolved at wait
    time (the overlap schedule keeps channel order).  ``wait`` is
    idempotent; a handle belongs to the engine that made it."""

    __slots__ = ("_thunk", "_result", "_err_prefix")

    def __init__(self, thunk: Callable[[], "torch.Tensor | None"] | None,
                 err_prefix: str = ""):
        self._thunk = thunk
        self._result: torch.Tensor | None = None
        self._err_prefix = err_prefix

    @classmethod
    def completed(cls, result: "torch.Tensor | None" = None
                  ) -> "Completion":
        c = cls(None)
        c._result = result
        return c

    def done(self) -> bool:
        """True once :meth:`wait` has completed (never before for a
        deferred receive: the payload is not consumed early)."""
        return self._thunk is None

    def wait(self) -> "torch.Tensor | None":
        if self._thunk is not None:
            thunk, self._thunk = self._thunk, None
            try:
                self._result = thunk()
            except TransportError as e:
                if self._err_prefix:
                    raise TransportError(f"{self._err_prefix}{e}") from e
                raise
        return self._result


class Transport:
    """Tagged point-to-point tensor transfer between integer-ranked
    endpoints, with sent-traffic accounting per (src, dst, tag) at the
    sending endpoint.  ``baton`` is the turn-taking lock of the threads
    that use it (one for every transport a process hosts)."""

    name = "abstract"
    num_endpoints: int
    baton: Baton

    def _init_common(self, baton: Baton | None) -> None:
        self.baton = baton if baton is not None else Baton()
        self._stats_lock = threading.Lock()
        self._stats: dict[tuple[int, int, int], LinkStats] = {}
        self._epochs: dict = {}

    def _count(self, src: int, dst: int, tag: int, n: int) -> None:
        with self._stats_lock:
            st = self._stats.get((src, dst, tag))
            if st is None:
                st = self._stats[(src, dst, tag)] = LinkStats()
            st.messages += 1
            st.bytes += n

    def connect(self) -> None:
        """Establish links (a no-op in-process)."""

    def send(self, src: int, dst: int, tag: int, data: torch.Tensor,
             copy: bool = True) -> None:
        raise NotImplementedError

    def recv(self, src: int, dst: int, tag: int,
             out: torch.Tensor | None = None,
             timeout: float | None = None) -> torch.Tensor:
        """Blocking receive of the next (src -> dst, tag) message.  With
        ``out``, the payload is also copied into it (reshaped)."""
        raise NotImplementedError

    def set_depth(self, src: int, dst: int, max_msgs: int = 0,
                  max_bytes: int | None = None) -> None:
        """Bound one link's pending messages and, unless ``max_bytes`` is
        None, its pending bytes (its producer blocks when full)."""
        raise NotImplementedError

    def reorder_stats(self) -> dict[tuple[int, int], ReorderStats]:
        """Receive-side reorder-buffer occupancy per (src, dst) link this
        transport holds: pending now, the high-water marks and the bounds.
        This is how a caller checks that the depth bounds held."""
        return {}

    def send_async(self, src: int, dst: int, tag: int, data: torch.Tensor,
                   copy: bool = True) -> Completion:
        """Send eagerly (a send blocks only on the link's depth bound) and
        return an already-completed handle."""
        self.send(src, dst, tag, data, copy=copy)
        return Completion.completed()

    def recv_async(self, src: int, dst: int, tag: int,
                   out: torch.Tensor | None = None,
                   timeout: float | None = None) -> Completion:
        """Post a deferred receive: nothing is consumed until ``wait()``,
        which runs the blocking ``recv`` into ``out``."""
        self._check_recv(src, dst)     # a bad rank raises here, not at wait
        return Completion(
            lambda: self.recv(src, dst, tag, out=out, timeout=timeout))

    def _check_recv(self, src: int, dst: int) -> None:
        pass

    def barrier(self, rank: int, group: Iterable[int],
                timeout: float | None = None,
                _base: int = _ENGINE_BARRIER_BASE) -> None:
        """Token all-to-all within ``group``: ``rank`` sends one empty
        message to every other member, then takes one from each.  Each
        rank keeps its own epoch count per group (aligned by program
        order), which picks the reserved tag; tokens stay out of
        ``stats()``."""
        group = list(group)
        key = (rank, frozenset(group), _base)
        with self._stats_lock:
            epoch = self._epochs.get(key, 0)
            self._epochs[key] = epoch + 1
        tag = _base - epoch
        token = torch.zeros(0, dtype=torch.uint8)
        for peer in group:
            if peer != rank:
                self.send(rank, peer, tag, token, copy=False)
        for peer in group:
            if peer != rank:
                self.recv(peer, rank, tag, timeout=timeout)

    def stats(self) -> dict[tuple[int, int, int], LinkStats]:
        """Snapshot of sent traffic per (src, dst, tag); barrier tokens
        are plumbing, not program traffic, and are left out."""
        with self._stats_lock:
            return {k: LinkStats(v.messages, v.bytes)
                    for k, v in self._stats.items()
                    if k[2] > _ENGINE_BARRIER_BASE}

    def link_totals(self) -> dict[tuple[int, int], LinkStats]:
        return aggregate_links(self.stats())

    def close(self) -> None:
        pass


class InprocTransport(Transport):
    """All endpoints in one process: per-link locked reorder buffers.
    Every thread that may wait on a link holds ``baton`` (see the module
    note)."""

    name = "inproc"

    def __init__(self, num_endpoints: int, baton: Baton | None = None):
        self.num_endpoints = num_endpoints
        self._links: dict[tuple[int, int], _Link] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._init_common(baton)

    def _link(self, src: int, dst: int) -> _Link:
        link = self._links.get((src, dst))
        if link is not None:
            return link
        n = self.num_endpoints
        if not (0 <= src < n and 0 <= dst < n) or src == dst:
            raise TransportError(f"bad link ({src} -> {dst}) for "
                                 f"{n}-endpoint fabric")
        with self._lock:
            link = self._links.setdefault((src, dst), _Link(self.baton))
            link.closed = link.closed or self._closed
            return link

    _check_recv = _link

    def set_depth(self, src: int, dst: int, max_msgs: int = 0,
                  max_bytes: int | None = None) -> None:
        self._link(src, dst).set_bounds(max_msgs, max_bytes)

    def reorder_stats(self) -> dict[tuple[int, int], ReorderStats]:
        with self._lock:
            links = list(self._links.items())
        return {k: link.reorder_stats() for k, link in links}

    def send(self, src: int, dst: int, tag: int, data: torch.Tensor,
             copy: bool = True) -> None:
        """Send a snapshot of ``data`` (a clone on its device), or, with
        ``copy=False``, ``data`` itself: a sender that never mutates it
        again (the garbled stream's freshly built tables) skips the
        copy."""
        link = self._link(src, dst)
        if copy:
            data = data.clone()
        self._count(src, dst, tag, nbytes(data))
        link.put(tag, data)

    def recv(self, src: int, dst: int, tag: int,
             out: torch.Tensor | None = None,
             timeout: float | None = None) -> torch.Tensor:
        data = self._link(src, dst).get(tag, timeout=timeout)
        if out is not None:
            out.copy_(data.reshape(out.shape))
        return data

    def close(self) -> None:
        """Close every link, also those made later: a blocked or deferred
        receive raises TransportClosed."""
        with self._lock:
            self._closed = True
            links = list(self._links.values())
        for link in links:
            link.close()


# ---------------------------------------------------------------------------
# TCP backend
# ---------------------------------------------------------------------------

# frame := !I total_len | !B kind | body     (the reference's framing)
#   kind 1 (hello): !q rank
#   kind 2 (data):  !qqq src dst tag | !B len(dtype) | dtype | !B ndim
#                   | !<ndim>q shape | payload
_K_HELLO, _K_DATA = 1, 2
_DATA_HEAD = struct.Struct("!Bqqq")


def _recv_exact(sock: socket.socket, n: int, into=None):
    """``n`` bytes from ``sock`` (into the writable buffer ``into`` when
    given), or None if the peer hung up first."""
    buf = memoryview(bytearray(n) if into is None else into).cast("B")
    got = 0
    while got < n:
        k = sock.recv_into(buf[got:], n - got)
        if not k:
            return None
        got += k
    return buf.obj if into is None else into


def _frame_head(src: int, dst: int, tag: int, arr: np.ndarray) -> bytes:
    """A data frame up to its payload (the length word counts both)."""
    dt = arr.dtype.str.encode()
    body = (_DATA_HEAD.pack(_K_DATA, src, dst, tag)
            + struct.pack("!B", len(dt)) + dt
            + struct.pack("!B", arr.ndim)
            + struct.pack(f"!{arr.ndim}q", *arr.shape))
    return struct.pack("!I", len(body) + arr.nbytes) + body


def _read_frame(sock: socket.socket
                ) -> tuple[int, int, int, np.ndarray] | None:
    """Read one data frame: (src, dst, tag, payload array), the payload
    received straight into an aligned array of its own; None at EOF."""
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (total,) = struct.unpack("!I", hdr)
    head = _recv_exact(sock, _DATA_HEAD.size + 1)
    if head is None:
        return None
    kind, src, dst, tag = _DATA_HEAD.unpack_from(head)
    if kind != _K_DATA:
        raise TransportError(f"unexpected frame kind {kind}")
    dlen = head[-1]
    rest = _recv_exact(sock, dlen + 1)
    if rest is None:
        return None
    dtype = np.dtype(bytes(rest[:dlen]).decode())
    ndim = rest[dlen]
    shape_b = _recv_exact(sock, 8 * ndim)
    if shape_b is None:
        return None
    shape = struct.unpack(f"!{ndim}q", shape_b)
    arr = np.empty(shape, dtype=dtype)
    left = total - (_DATA_HEAD.size + 2 + dlen + 8 * ndim)
    if left != arr.nbytes:
        raise TransportError(f"frame payload {left} B for a {shape} "
                             f"{dtype} array")
    if left and _recv_exact(sock, left, into=arr) is None:
        return None
    return src, dst, tag, arr


def parse_addr(text: str) -> tuple[str, int]:
    host, _, port = text.rpartition(":")
    if not host or not port.isdigit():
        raise TransportError(f"bad peer address {text!r} (want host:port)")
    return host, int(port)


def pick_free_ports(n: int, host: str = "127.0.0.1") -> list[int]:
    """Reserve n distinct free TCP ports (bound sockets held until all
    are picked, then released: good enough for localhost fleets)."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind((host, 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def _host_array(data: torch.Tensor) -> np.ndarray:
    """The host copy of a tensor as a contiguous array: for a device
    tensor the ``.cpu()`` copy, which is the send's snapshot."""
    t = data.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    return np.ascontiguousarray(t.numpy())


class TcpTransport(Transport):
    """One endpoint of a multi-process fabric over sockets.

    ``addrs[k]`` is rank k's ``host:port``.  Each rank listens on its own
    port and dials one outbound (send-only) connection to every peer;
    inbound connections are receive-only, each drained by a reader thread
    into the per-link reorder buffers as host tensors.  ``recv`` returns
    the message on ``device``.  Readers apply byte-bounded backpressure
    (``max_link_bytes``, or ``set_depth``): a link whose receiver lags
    stops being read, which pushes back through TCP flow control to the
    sender, whose blocked ``sendall`` gives the baton up."""

    name = "tcp"

    def __init__(self, rank: int, addrs: Sequence[str],
                 device: torch.device | str = "cpu",
                 connect_timeout: float = 30.0,
                 max_link_bytes: int = 64 << 20,
                 baton: Baton | None = None):
        self.rank = rank
        self.addrs = [parse_addr(a) for a in addrs]
        if not 0 <= rank < len(self.addrs):
            raise TransportError(f"rank {rank} outside {len(self.addrs)} "
                                 f"peer addresses")
        self.num_endpoints = len(self.addrs)
        self.device = torch.device(device)
        self.connect_timeout = connect_timeout
        self.max_link_bytes = max_link_bytes
        self._links: dict[tuple[int, int], _Link] = {}
        self._links_lock = threading.Lock()
        self._dead_peers: set[int] = set()
        self._out: dict[int, socket.socket] = {}
        self._out_locks: dict[int, threading.Lock] = {}
        self._listener: socket.socket | None = None
        self._in: list[socket.socket] = []
        self._readers: list[threading.Thread] = []
        self._accepted = threading.Semaphore(0)
        self._accept_err: list[Exception] = []
        self._closed = False
        self._init_common(baton)

    # -- wiring ---------------------------------------------------------------

    def _link(self, src: int, dst: int) -> _Link:
        link = self._links.get((src, dst))
        if link is None:
            with self._links_lock:
                link = self._links.setdefault(
                    (src, dst), _Link(self.baton,
                                      max_bytes=self.max_link_bytes))
                # a link first touched after its peer hung up (or after
                # close()) is born closed, or its recv would wait forever
                if self._closed or (dst == self.rank
                                    and src in self._dead_peers):
                    link.close()
        return link

    def listen(self) -> None:
        """Bind and start accepting inbound connections (idempotent).
        Split from :meth:`connect` so that a fabric hosting several ranks
        in one process opens every listener before anyone dials."""
        n = self.num_endpoints
        if n == 1 or self._listener is not None:
            return
        host, port = self.addrs[self.rank]
        lsock = socket.socket()
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((host, port))
        lsock.listen(n)
        self._listener = lsock

        def accept_loop():
            try:
                for _ in range(n - 1):
                    conn, _ = lsock.accept()
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                    1)
                    hdr = _recv_exact(conn, 4)
                    if hdr is None:
                        raise TransportError("peer hung up during hello")
                    body = _recv_exact(conn, struct.unpack("!I", hdr)[0])
                    kind, peer = struct.unpack("!Bq", body)
                    if kind != _K_HELLO:
                        raise TransportError(f"expected hello, got kind "
                                             f"{kind}")
                    t = threading.Thread(target=self._read_loop,
                                         args=(conn, peer), daemon=True,
                                         name=f"tcp-read-{peer}->{self.rank}")
                    t.start()
                    self._in.append(conn)
                    self._readers.append(t)
                    self._accepted.release()
            except Exception as e:  # surfaced by connect()
                if not self._closed:
                    self._accept_err.append(e)
                self._accepted.release()

        threading.Thread(target=accept_loop, daemon=True,
                         name=f"tcp-accept-{self.rank}").start()

    def connect(self) -> None:
        n = self.num_endpoints
        if n == 1:
            return
        self.listen()
        deadline = time.monotonic() + self.connect_timeout
        for peer in range(n):
            if peer != self.rank:
                self._out[peer] = self._dial(peer, deadline)
                self._out_locks[peer] = threading.Lock()
        for _ in range(n - 1):
            left = deadline - time.monotonic()
            if not self._accepted.acquire(timeout=max(left, 0.01)):
                raise TransportError(f"rank {self.rank}: timed out waiting "
                                     f"for inbound connections")
            if self._accept_err:
                raise self._accept_err[0]

    def _dial(self, peer: int, deadline: float) -> socket.socket:
        host, port = self.addrs[peer]
        last: Exception | None = None
        while time.monotonic() < deadline:
            try:
                s = socket.create_connection((host, port), timeout=2.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(None)
                hello = struct.pack("!Bq", _K_HELLO, self.rank)
                s.sendall(struct.pack("!I", len(hello)) + hello)
                return s
            except OSError as e:
                last = e
                time.sleep(0.05)
        raise TransportError(f"rank {self.rank}: cannot reach rank {peer} "
                             f"at {host}:{port}: {last}")

    def _read_loop(self, conn: socket.socket, peer: int) -> None:
        """Drain one inbound connection.  Holds no baton: its puts wait on
        a full link without touching it."""
        try:
            while True:
                frame = _read_frame(conn)
                if frame is None:
                    return
                src, dst, tag, arr = frame
                if dst != self.rank:
                    raise TransportError(
                        f"rank {self.rank} got a frame for rank {dst}")
                self._link(src, dst).put(tag, torch.from_numpy(arr))
        except (TransportClosed, OSError):
            pass
        finally:
            conn.close()
            # wake any recv still waiting on this peer; the dead-peer mark
            # (taken under the links lock) also closes links made later
            with self._links_lock:
                self._dead_peers.add(peer)
                links = list(self._links.items())
            for (src, _dst), link in links:
                if src == peer:
                    link.close()

    # -- data path ------------------------------------------------------------

    def _sendall(self, sock: socket.socket, buf) -> None:
        """``sendall`` that gives the baton up if it has to block: what
        the socket takes without waiting goes first, the rest blocking."""
        view = memoryview(buf).cast("B")
        while view.nbytes:
            try:
                k = sock.send(view, socket.MSG_DONTWAIT)
            except BlockingIOError:
                released = self.baton.give_up()
                try:
                    sock.sendall(view)
                finally:
                    if released:
                        self.baton.acquire()
                return
            view = view[k:]

    def send(self, src: int, dst: int, tag: int, data: torch.Tensor,
             copy: bool = True) -> None:
        # ``copy`` is moot: the host copy and the frame own the bytes
        if src != self.rank:
            raise TransportError(f"endpoint {self.rank} cannot send "
                                 f"as rank {src}")
        sock = self._out.get(dst)
        if sock is None:
            raise TransportError(f"no connection to rank {dst} "
                                 f"(connect() not run?)")
        arr = _host_array(data)
        head = _frame_head(src, dst, tag, arr)
        with self._out_locks[dst]:
            self._sendall(sock, head)
            if arr.nbytes:
                self._sendall(sock, arr)
        self._count(src, dst, tag, arr.nbytes)

    def _check_recv(self, src: int, dst: int) -> None:
        if dst != self.rank:
            raise TransportError(f"endpoint {self.rank} cannot recv "
                                 f"as rank {dst}")

    def recv(self, src: int, dst: int, tag: int,
             out: torch.Tensor | None = None,
             timeout: float | None = None) -> torch.Tensor:
        """The next (src -> dst, tag) message on this transport's device;
        with ``out``, copied into it (reshaped) and ``out`` returned."""
        self._check_recv(src, dst)
        data = self._link(src, dst).get(tag, timeout=timeout)
        if out is not None:
            out.copy_(data.reshape(out.shape))
            return out
        return data.to(self.device)

    def set_depth(self, src: int, dst: int, max_msgs: int = 0,
                  max_bytes: int | None = None) -> None:
        """Bound one inbound link's pending messages and, unless
        ``max_bytes`` is None (then ``max_link_bytes`` stays), its pending
        bytes.  The reader blocks in ``put`` when a bound is hit, which
        stops draining the socket and pushes back to the sender through
        TCP flow control."""
        self._link(src, dst).set_bounds(max_msgs, max_bytes)

    def reorder_stats(self) -> dict[tuple[int, int], ReorderStats]:
        with self._links_lock:
            links = list(self._links.items())
        return {k: link.reorder_stats() for k, link in links}

    def close(self) -> None:
        self._closed = True
        for sock in self._out.values():
            try:
                sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            sock.close()
        if self._listener is not None:
            self._listener.close()
        # unblock our readers now: by close() time every hosted engine has
        # finished its program, so anything still in flight is stray
        for conn in self._in:
            try:
                conn.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        for t in self._readers:
            t.join(timeout=5.0)
        with self._links_lock:
            links = list(self._links.values())
        for link in links:
            link.close()


# ---------------------------------------------------------------------------
# shaped decorator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LinkShape:
    latency_s: float = 0.0          # one-way delivery delay
    bandwidth: float | None = None  # bytes/s (None: unconstrained)


class ShapedTransport(Transport):
    """One link shape (latency, bandwidth) for every link of another
    transport.

    The sender stamps each message with a virtual delivery time from
    pipelined link occupancy (a message serializes onto the link at
    ``bandwidth`` after the previous one clears; ``latency`` delays
    delivery, not occupancy), and ``recv`` sleeps until that time.  The
    stamps ride in a side table, so sender and receiver share the
    process; with ``paced_send=True`` the sender sleeps until the
    delivery time instead (the ``shaped+tcp`` backend), which charges the
    latency at the sender: exact for the bandwidth term and for ping-pong
    exchanges, an upper bound otherwise.  Every sleep gives the baton
    up."""

    name = "shaped"

    def __init__(self, inner: Transport, shape: LinkShape | None = None,
                 paced_send: bool = False):
        self.inner = inner
        self.shape = shape or LinkShape()
        self.paced_send = paced_send
        self._busy: dict[tuple[int, int], float] = {}
        self._deliver: dict[tuple[int, int, int], deque] = {}
        self._lock = threading.Lock()
        self.num_endpoints = inner.num_endpoints
        self._init_common(inner.baton)   # barrier epochs; stats are inner's

    def send(self, src: int, dst: int, tag: int, data: torch.Tensor,
             copy: bool = True) -> None:
        sh = self.shape
        now = time.monotonic()
        with self._lock:
            start = max(now, self._busy.get((src, dst), 0.0))
            xfer = nbytes(data) / sh.bandwidth if sh.bandwidth else 0.0
            self._busy[(src, dst)] = start + xfer
            due = start + xfer + sh.latency_s
            if not self.paced_send:
                self._deliver.setdefault((src, dst, tag), deque()).append(due)
        if self.paced_send:
            _sleep(self.baton, due - time.monotonic())
        self.inner.send(src, dst, tag, data, copy=copy)

    def recv(self, src: int, dst: int, tag: int,
             out: torch.Tensor | None = None,
             timeout: float | None = None) -> torch.Tensor:
        data = self.inner.recv(src, dst, tag, timeout=timeout)
        if not self.paced_send:
            with self._lock:
                q = self._deliver.get((src, dst, tag))
                due = q.popleft() if q else 0.0
            _sleep(self.baton, due - time.monotonic())
        if out is not None:
            out.copy_(data.reshape(out.shape))
        return data

    def _check_recv(self, src: int, dst: int) -> None:
        self.inner._check_recv(src, dst)

    def set_depth(self, src: int, dst: int, max_msgs: int = 0,
                  max_bytes: int | None = None) -> None:
        self.inner.set_depth(src, dst, max_msgs, max_bytes)

    def reorder_stats(self) -> dict[tuple[int, int], ReorderStats]:
        return self.inner.reorder_stats()

    def listen(self) -> None:
        if hasattr(self.inner, "listen"):
            self.inner.listen()

    def connect(self) -> None:
        self.inner.connect()

    def close(self) -> None:
        self.inner.close()

    def stats(self) -> dict[tuple[int, int, int], LinkStats]:
        return self.inner.stats()


# ---------------------------------------------------------------------------
# placement: party views, the fabric, the registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """Endpoint-to-process placement and link shaping for one job.

    ``rank=None`` hosts every endpoint in this process; ``rank=k`` hosts
    exactly endpoint k, and ``peers`` lists every rank's ``host:port`` in
    rank order (also needed for ``tcp`` with ``rank=None``).
    ``latency_s`` and ``bandwidth`` shape the ``shaped`` backends' links.
    """

    rank: int | None = None
    peers: tuple[str, ...] = ()
    latency_s: float = 0.0
    bandwidth: float | None = None
    connect_timeout_s: float = 30.0

    def __post_init__(self):
        object.__setattr__(self, "peers", tuple(self.peers))


class PartyView:
    """One party's window onto the fabric, addressed by worker id.

    The engine speaks worker ids (the NET_* immediates); the view offsets
    them into the global rank space (``rank = base + worker``).
    ``recv_timeout`` bounds every NET_RECV, so a mis-tagged send or a dead
    sibling engine raises a TransportError instead of hanging the run."""

    RECV_TIMEOUT_S = 600.0

    def __init__(self, transport: Transport, base: int, num_workers: int,
                 recv_timeout: float | None = None):
        self.transport = transport
        self.base = base
        self.num_workers = num_workers
        self.recv_timeout = (self.RECV_TIMEOUT_S if recv_timeout is None
                             else recv_timeout)

    def send(self, src: int, dst: int, tag: int, data: torch.Tensor) -> None:
        self.transport.send(self.base + src, self.base + dst, tag, data)

    def recv(self, src: int, dst: int, tag: int,
             out: torch.Tensor | None = None) -> torch.Tensor:
        try:
            return self.transport.recv(self.base + src, self.base + dst,
                                       tag, out=out,
                                       timeout=self.recv_timeout)
        except TransportError as e:
            raise TransportError(
                f"NET_RECV worker{src}->worker{dst} tag={tag}: {e}") from e

    def send_async(self, src: int, dst: int, tag: int,
                   data: torch.Tensor) -> Completion:
        return self.transport.send_async(self.base + src, self.base + dst,
                                         tag, data)

    def recv_async(self, src: int, dst: int, tag: int,
                   out: torch.Tensor | None = None) -> Completion:
        c = self.transport.recv_async(self.base + src, self.base + dst,
                                      tag, out=out,
                                      timeout=self.recv_timeout)
        c._err_prefix = f"NET_RECV worker{src}->worker{dst} tag={tag}: "
        return c

    def barrier(self, rank: int) -> None:
        group = range(self.base, self.base + self.num_workers)
        self.transport.barrier(self.base + rank, group,
                               timeout=self.recv_timeout)


class Fabric:
    """The endpoints this process hosts (all of them, or one: distributed
    mode) and their transports, behind one connect / stats / barrier /
    close surface.  ``baton`` is the one turn-taking lock of every hosted
    transport (``core.workers.run_engines`` holds it per engine)."""

    BARRIER_TIMEOUT_S = 600.0

    def __init__(self, name: str, num_endpoints: int,
                 transports: dict[int, Transport], baton: Baton):
        self.name = name
        self.num_endpoints = num_endpoints
        self.transports = transports
        self.hosted = sorted(transports)
        self.baton = baton
        self._epoch = 0

    @property
    def distributed(self) -> bool:
        return len(self.hosted) < self.num_endpoints

    def _unique(self) -> list[Transport]:
        seen: list[Transport] = []
        for t in self.transports.values():
            if all(t is not s for s in seen):
                seen.append(t)
        return seen

    def connect(self) -> None:
        """Open every hosted listener before anyone dials, then dial
        concurrently: co-hosted TCP ranks wait on each other's inbound
        connections, so connecting one after another would deadlock."""
        uniq = self._unique()
        for t in uniq:
            if hasattr(t, "listen"):
                t.listen()
        if len(uniq) == 1:
            uniq[0].connect()
            return
        errs: list[Exception] = []

        def run(t):
            try:
                t.connect()
            except Exception as e:  # re-raised below
                errs.append(e)

        threads = [threading.Thread(target=run, args=(t,), daemon=True)
                   for t in uniq]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errs:
            raise errs[0]

    def close(self) -> None:
        for t in self._unique():
            t.close()

    def transport_for(self, rank: int) -> Transport:
        try:
            return self.transports[rank]
        except KeyError:
            raise TransportError(f"rank {rank} is not hosted by this "
                                 f"process (hosted: {self.hosted})") from None

    def view(self, rank: int, base: int, num_workers: int) -> PartyView:
        return PartyView(self.transport_for(rank), base, num_workers)

    def stats(self) -> dict[tuple[int, int, int], LinkStats]:
        """Sent traffic merged over the hosted endpoints (send-side
        accounting keeps the union disjoint)."""
        out: dict[tuple[int, int, int], LinkStats] = {}
        for t in self._unique():
            for k, s in t.stats().items():
                agg = out.setdefault(k, LinkStats())
                agg.messages += s.messages
                agg.bytes += s.bytes
        return out

    def link_totals(self) -> dict[tuple[int, int], LinkStats]:
        return aggregate_links(self.stats())

    def reorder_stats(self) -> dict[tuple[int, int], ReorderStats]:
        """Receive-side reorder occupancy merged over the hosted endpoints
        (a link's buffer lives at its receiving endpoint, so two hosted
        transports never report one key)."""
        out: dict[tuple[int, int], ReorderStats] = {}
        for t in self._unique():
            out.update(t.reorder_stats())
        return out

    def barrier(self) -> None:
        """Full-fabric barrier: each hosted rank exchanges a token with
        every rank, which holds a distributed process open until every
        peer has drained its traffic."""
        group = range(self.num_endpoints)
        tag = _FABRIC_BARRIER_BASE - self._epoch
        self._epoch += 1
        token = torch.zeros(0, dtype=torch.uint8)
        for r in self.hosted:
            t = self.transport_for(r)
            for peer in group:
                if peer != r:
                    t.send(r, peer, tag, token, copy=False)
        for r in self.hosted:
            t = self.transport_for(r)
            for peer in group:
                if peer != r:
                    t.recv(peer, r, tag, timeout=self.BARRIER_TIMEOUT_S)


#: a factory builds the transports of the hosted ranks:
#: ``factory(num_endpoints, spec, hosted, device=..., baton=...)``
TransportFactory = Callable[..., dict[int, Transport]]

TRANSPORTS: dict[str, TransportFactory] = {}


def register_transport(name: str, factory: TransportFactory) -> None:
    TRANSPORTS[name] = factory


def _make_inproc(n: int, spec: FabricSpec, hosted, *, device, baton
                 ) -> dict[int, Transport]:
    if spec.rank is not None:
        raise TransportError("inproc transport cannot host a single rank; "
                             "use tcp for distributed placement")
    t = InprocTransport(n, baton=baton)
    return {r: t for r in hosted}


def _make_tcp(n: int, spec: FabricSpec, hosted, *, device, baton
              ) -> dict[int, Transport]:
    if len(spec.peers) != n:
        raise TransportError(f"tcp fabric needs {n} peer addresses "
                             f"(one per rank), got {len(spec.peers)}")
    return {r: TcpTransport(r, spec.peers, device=device,
                            connect_timeout=spec.connect_timeout_s,
                            baton=baton)
            for r in hosted}


def _make_shaped(n: int, spec: FabricSpec, hosted, *, device, baton
                 ) -> dict[int, Transport]:
    if spec.rank is not None:
        raise TransportError("shaped transport is same-process only; use "
                             "shaped+tcp for cross-process links")
    t = ShapedTransport(InprocTransport(n, baton=baton),
                        LinkShape(latency_s=spec.latency_s,
                                  bandwidth=spec.bandwidth))
    return {r: t for r in hosted}


def _make_shaped_tcp(n: int, spec: FabricSpec, hosted, *, device, baton
                     ) -> dict[int, Transport]:
    """``shaped`` over the tcp backend: every hosted rank gets its own
    sender-paced decorator (no side table crosses processes), so it
    composes with single-rank placement."""
    inner = _make_tcp(n, spec, hosted, device=device, baton=baton)
    shape = LinkShape(latency_s=spec.latency_s, bandwidth=spec.bandwidth)
    return {r: ShapedTransport(t, shape, paced_send=True)
            for r, t in inner.items()}


register_transport("inproc", _make_inproc)
register_transport("tcp", _make_tcp)
register_transport("shaped", _make_shaped)
register_transport("shaped+tcp", _make_shaped_tcp)


def build_fabric(name: str, num_endpoints: int,
                 spec: FabricSpec | None = None,
                 device: torch.device | str = "cpu") -> Fabric:
    """Build (but do not connect) the fabric for one job; ``device`` is
    where a TCP endpoint hands its received messages."""
    spec = spec or FabricSpec()
    try:
        factory = TRANSPORTS[name]
    except KeyError:
        raise KeyError(f"unknown transport {name!r}; registered: "
                       f"{sorted(TRANSPORTS)}") from None
    if spec.rank is None:
        hosted: Iterable[int] = range(num_endpoints)
    else:
        if not 0 <= spec.rank < num_endpoints:
            raise TransportError(f"fabric rank {spec.rank} outside "
                                 f"{num_endpoints} endpoints")
        hosted = (spec.rank,)
    baton = Baton()
    return Fabric(name, num_endpoints,
                  factory(num_endpoints, spec, hosted,
                          device=torch.device(device), baton=baton), baton)
