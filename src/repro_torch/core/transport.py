"""In-process transport for every message between engines: the port's
copy of the ``InprocTransport`` part of ``repro.core.transport``.
Messages are tensors.

One fabric carries both kinds of traffic: the intra-party NET_*
directives of multi-worker jobs (worker links, addressed through a
:class:`PartyView`) and the garbled-circuit party stream (garbler worker
k to evaluator worker k, ``protocols.garbled.gates.PartyChannel``).  Rank
space: a fabric with P parties of W workers has ``P * W`` endpoints,
``rank = party * W + worker``.

Each (src, dst) link keeps a per-tag FIFO: distinct tags buffer
independently, so out-of-order tags match instead of raising.  A link may
bound its pending set (``set_depth``) so that a producer running ahead
blocks instead of materializing the whole garbled circuit (§2.4.2), and a
receive may time out, which turns a protocol desync into an error instead
of a hang.  ``send`` snapshots the tensor (``copy=True``, a clone on its
device) unless the sender promises never to mutate it again
(``copy=False``: the party channel's freshly built tables).  Every engine
thread launches on its device's current stream, so the snapshot is
ordered before the receiver's ``copy_`` into its memory.

The endpoint threads take turns: each holds the transport's *baton*, a
lock, while it runs and gives it up only while it waits on a link, so at
most one of them competes for the interpreter lock.  Two threads that both
launch tensor ops (each of which releases the interpreter lock) would
otherwise hand that lock back and forth on every op, and the handoffs cost
far more than the ops.  Every wait gives the baton up: a link wait, a
deferred receive's ``Completion.wait`` and a barrier's token receives.
The TCP and shaped backends and fabrics wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Sequence

import torch


class TransportError(RuntimeError):
    pass


class TransportClosed(TransportError):
    """The link closed with a receive still outstanding."""


@dataclasses.dataclass
class LinkStats:
    messages: int = 0
    bytes: int = 0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: reserved tag range (ordinary tags are small non-negative ints: the DSL's
#: fresh_tag counter and the garbled kind tags): barrier tokens use deeply
#: negative tags, so they never collide with data on the same link
_ENGINE_BARRIER_BASE = -(1 << 40)


def aggregate_links(stats: dict[tuple[int, int, int], LinkStats]
                    ) -> dict[tuple[int, int], LinkStats]:
    """(src, dst, tag) stats -> per-(src, dst) link totals."""
    out: dict[tuple[int, int], LinkStats] = {}
    for (src, dst, _tag), s in stats.items():
        t = out.setdefault((src, dst), LinkStats())
        t.messages += s.messages
        t.bytes += s.bytes
    return out


class _Link:
    """One (src, dst) lane: a locked per-tag reorder buffer.  A blocked
    ``put`` or ``get`` gives up the ``baton`` while it waits and takes it
    back once it has left the link's lock."""

    def __init__(self, baton: threading.Lock, max_msgs: int = 0):
        self._cond = threading.Condition()
        self._by_tag: dict[int, deque] = {}
        self._pending = 0
        self._baton = baton
        self.max_msgs = max_msgs
        self.closed = False

    def _wait(self, timeout: float | None, holding: bool) -> bool:
        """Wait on the link (its lock held); returns whether this thread
        still holds the baton."""
        if holding:
            self._baton.release()
        self._cond.wait(timeout)
        return False

    def put(self, tag: int, data: torch.Tensor) -> None:
        holding = True
        try:
            with self._cond:
                while self.max_msgs and self._pending >= self.max_msgs \
                        and not self.closed:
                    holding = self._wait(None, holding)
                if self.closed:
                    raise TransportClosed("send on closed link")
                self._by_tag.setdefault(tag, deque()).append(data)
                self._pending += 1
                self._cond.notify_all()
        finally:
            if not holding:
                self._baton.acquire()

    def get(self, tag: int, timeout: float | None = None) -> torch.Tensor:
        deadline = None if timeout is None else time.monotonic() + timeout
        holding = True
        try:
            with self._cond:
                while True:
                    q = self._by_tag.get(tag)
                    if q:
                        data = q.popleft()
                        if not q:
                            del self._by_tag[tag]
                        self._pending -= 1
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
                    holding = self._wait(left, holding)
        finally:
            if not holding:
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


class InprocTransport:
    """All endpoints in one process: per-link locked reorder buffers, with
    sent-traffic accounting per (src, dst, tag).  Every thread that sends
    or receives must hold ``baton`` (see the module note)."""

    name = "inproc"

    def __init__(self, num_endpoints: int):
        self.num_endpoints = num_endpoints
        self.baton = threading.Lock()
        self._links: dict[tuple[int, int], _Link] = {}
        self._lock = threading.Lock()
        self._stats: dict[tuple[int, int, int], LinkStats] = {}
        self._epochs: dict = {}
        self._closed = False

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

    def set_depth(self, src: int, dst: int, max_msgs: int = 0) -> None:
        """Bound one link's pending set (senders block when full)."""
        self._link(src, dst).max_msgs = max_msgs

    def send(self, src: int, dst: int, tag: int, data: torch.Tensor,
             copy: bool = True) -> None:
        """Send a snapshot of ``data`` (a clone on its device), or, with
        ``copy=False``, ``data`` itself: a sender that never mutates it
        again (the garbled stream's freshly built tables) skips the
        copy."""
        link = self._link(src, dst)
        if copy:
            data = data.clone()
        with self._lock:
            st = self._stats.setdefault((src, dst, tag), LinkStats())
            st.messages += 1
            st.bytes += nbytes(data)
        link.put(tag, data)

    def recv(self, src: int, dst: int, tag: int,
             out: torch.Tensor | None = None,
             timeout: float | None = None) -> torch.Tensor:
        """Blocking receive of the next (src -> dst, tag) message.  With
        ``out``, the payload is also copied into it (reshaped)."""
        data = self._link(src, dst).get(tag, timeout=timeout)
        if out is not None:
            out.copy_(data.reshape(out.shape))
        return data

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
        self._link(src, dst)          # a bad rank raises here, not at wait
        return Completion(
            lambda: self.recv(src, dst, tag, out=out, timeout=timeout))

    def barrier(self, rank: int, group: Sequence[int],
                timeout: float | None = None) -> None:
        """Token all-to-all within ``group``: ``rank`` sends one empty
        message to every other member, then takes one from each.  Each
        rank keeps its own epoch count per group (aligned by program
        order), which picks the reserved tag; tokens stay out of
        ``stats()``."""
        key = (rank, frozenset(group))
        with self._lock:
            epoch = self._epochs.get(key, 0)
            self._epochs[key] = epoch + 1
        tag = _ENGINE_BARRIER_BASE - epoch
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
        with self._lock:
            return {k: LinkStats(v.messages, v.bytes)
                    for k, v in self._stats.items()
                    if k[2] > _ENGINE_BARRIER_BASE}

    def link_totals(self) -> dict[tuple[int, int], LinkStats]:
        return aggregate_links(self.stats())

    def close(self) -> None:
        """Close every link, also those made later: a blocked or deferred
        receive raises TransportClosed."""
        with self._lock:
            self._closed = True
            links = list(self._links.values())
        for link in links:
            link.close()


class PartyView:
    """One party's window onto the fabric, addressed by worker id.

    The engine speaks worker ids (the NET_* immediates); the view offsets
    them into the global rank space (``rank = base + worker``).
    ``recv_timeout`` bounds every NET_RECV, so a mis-tagged send or a dead
    sibling engine raises a TransportError instead of hanging the run."""

    RECV_TIMEOUT_S = 600.0

    def __init__(self, transport: InprocTransport, base: int,
                 num_workers: int, recv_timeout: float | None = None):
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
