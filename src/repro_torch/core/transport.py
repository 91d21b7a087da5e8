"""In-process transport for the two parties' protocol stream: the port's
copy of the ``InprocTransport`` subset of ``repro.core.transport`` that
the party channel needs.  Messages are tensors, passed by reference.

Each (src, dst) link keeps a per-tag FIFO; a link may bound its pending
set (``set_depth``) so that a producer running ahead blocks instead of
materializing the whole garbled circuit (§2.4.2), and a receive may time
out, which turns a protocol desync into an error instead of a hang.

The endpoint threads take turns: each holds the transport's *baton*, a
lock, while it runs and gives it up only while it waits on a link, so at
most one of them competes for the interpreter lock.  Two threads that both
launch tensor ops (each of which releases the interpreter lock) would
otherwise hand that lock back and forth on every op, and the handoffs cost
far more than the ops.  The TCP and shaped backends, fabrics and barriers
wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

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

    def _link(self, src: int, dst: int) -> _Link:
        link = self._links.get((src, dst))
        if link is not None:
            return link
        n = self.num_endpoints
        if not (0 <= src < n and 0 <= dst < n) or src == dst:
            raise TransportError(f"bad link ({src} -> {dst}) for "
                                 f"{n}-endpoint fabric")
        with self._lock:
            return self._links.setdefault((src, dst), _Link(self.baton))

    def set_depth(self, src: int, dst: int, max_msgs: int = 0) -> None:
        """Bound one link's pending set (senders block when full)."""
        self._link(src, dst).max_msgs = max_msgs

    def send(self, src: int, dst: int, tag: int, data: torch.Tensor) -> None:
        """Hand ``data`` over by reference: the sender must not mutate it
        afterwards (protocol messages are freshly built)."""
        link = self._link(src, dst)
        with self._lock:
            st = self._stats.setdefault((src, dst, tag), LinkStats())
            st.messages += 1
            st.bytes += nbytes(data)
        link.put(tag, data)

    def recv(self, src: int, dst: int, tag: int,
             timeout: float | None = None) -> torch.Tensor:
        return self._link(src, dst).get(tag, timeout=timeout)

    def stats(self) -> dict[tuple[int, int, int], LinkStats]:
        """Snapshot of sent traffic per (src, dst, tag)."""
        with self._lock:
            return {k: LinkStats(v.messages, v.bytes)
                    for k, v in self._stats.items()}

    def close(self) -> None:
        with self._lock:
            links = list(self._links.values())
        for link in links:
            link.close()
