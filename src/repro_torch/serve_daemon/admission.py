"""Admission control: a shared frame pool + memory budget across tenants
(the port's copy of ``repro.serve_daemon.admission``; host logic).

The planner's and engine's footprints are O(frames)
(``core.planner.plan_memory_estimate``; on the card the engine's frames
live in device memory), so the daemon bounds
concurrent sessions by the frames they will pin: a job needs
``sum(cfg.num_frames)`` frames across its workers, and the controller
admits jobs only while the running total stays within ``frame_pool``
(and, when configured, their memory estimates within ``memory_bytes``).

Jobs that do not fit *right now* wait on a FIFO ticket queue (so a
stream of small jobs cannot starve a large one) unless they asked not
to queue, in which case — and whenever a job could *never* fit — an
:class:`AdmissionError` with the concrete numbers is raised for the
protocol layer to surface.
"""

from __future__ import annotations

import collections
import dataclasses
import threading


class AdmissionError(RuntimeError):
    """The job would overcommit the shared frame pool / memory budget."""


@dataclasses.dataclass
class _Ticket:
    frames: int
    mem_bytes: int
    granted: bool = False


class AdmissionController:
    """Bounds concurrent jobs by frames (and optionally bytes)."""

    def __init__(self, frame_pool: int, memory_bytes: int | None = None,
                 max_queue: int = 64):
        if frame_pool <= 0:
            raise ValueError("frame_pool must be positive")
        self.frame_pool = frame_pool
        self.memory_bytes = memory_bytes
        self.max_queue = max_queue
        self._cv = threading.Condition()
        self._queue: collections.deque[_Ticket] = collections.deque()
        self.frames_in_use = 0
        self.bytes_in_use = 0
        self.active = 0
        self.admitted = 0
        self.rejected = 0
        self.peak_frames = 0
        self.queued_peak = 0

    # -- core ----------------------------------------------------------------

    def _fits(self, t: _Ticket) -> bool:
        if self.frames_in_use + t.frames > self.frame_pool:
            return False
        if self.memory_bytes is not None and \
                self.bytes_in_use + t.mem_bytes > self.memory_bytes:
            return False
        return True

    def _check_possible(self, frames: int, mem_bytes: int) -> None:
        if frames > self.frame_pool:
            raise AdmissionError(
                f"job needs {frames} frames but the shared frame pool is "
                f"{self.frame_pool}; it can never be admitted — lower the "
                f"memory_budget or raise the daemon's --frame-pool")
        if self.memory_bytes is not None and mem_bytes > self.memory_bytes:
            raise AdmissionError(
                f"job's estimated {mem_bytes} bytes exceed the daemon's "
                f"memory budget of {self.memory_bytes} bytes")

    def admit(self, frames: int, mem_bytes: int = 0, queue: bool = True,
              timeout: float | None = None) -> "Admission":
        """Block until the job fits (FIFO), then reserve its resources.

        ``queue=False`` turns a would-wait into an immediate
        :class:`AdmissionError`; a job larger than the whole pool is
        always an error.  Returns a context manager releasing the
        reservation on exit."""
        frames = max(int(frames), 0)
        t = _Ticket(frames, max(int(mem_bytes), 0))
        with self._cv:
            self._check_possible(t.frames, t.mem_bytes)
            if not self._fits(t) or self._queue:
                if not queue:
                    self.rejected += 1
                    raise AdmissionError(
                        f"admission would overcommit: {frames} frames "
                        f"requested, {self.frames_in_use}/{self.frame_pool} "
                        f"in use and the job declined to queue")
                if len(self._queue) >= self.max_queue:
                    self.rejected += 1
                    raise AdmissionError(
                        f"admission queue is full ({self.max_queue} jobs "
                        f"waiting)")
                self._queue.append(t)
                self.queued_peak = max(self.queued_peak, len(self._queue))
                ok = self._cv.wait_for(lambda: t.granted, timeout)
                if not ok:
                    self._queue.remove(t)
                    self.rejected += 1
                    self._pump()
                    raise AdmissionError(
                        f"timed out after {timeout}s waiting for "
                        f"{frames} frames")
            else:
                self._grant(t)
            return Admission(self, t)

    def _grant(self, t: _Ticket) -> None:
        t.granted = True
        self.frames_in_use += t.frames
        self.bytes_in_use += t.mem_bytes
        self.active += 1
        self.admitted += 1
        self.peak_frames = max(self.peak_frames, self.frames_in_use)

    def _pump(self) -> None:
        """Grant queued tickets in FIFO order while they fit."""
        granted = False
        while self._queue and self._fits(self._queue[0]):
            self._grant(self._queue.popleft())
            granted = True
        if granted:
            self._cv.notify_all()

    def release(self, t: _Ticket) -> None:
        with self._cv:
            self.frames_in_use -= t.frames
            self.bytes_in_use -= t.mem_bytes
            self.active -= 1
            self._pump()

    def status(self) -> dict:
        with self._cv:
            return {"frame_pool": self.frame_pool,
                    "memory_bytes": self.memory_bytes,
                    "frames_in_use": self.frames_in_use,
                    "bytes_in_use": self.bytes_in_use,
                    "active": self.active, "waiting": len(self._queue),
                    "admitted": self.admitted, "rejected": self.rejected,
                    "peak_frames": self.peak_frames,
                    "queued_peak": self.queued_peak}


class Admission:
    """A granted reservation; release by exiting the ``with`` block."""

    def __init__(self, ctl: AdmissionController, ticket: _Ticket):
        self._ctl = ctl
        self._ticket = ticket
        self.frames = ticket.frames

    def __enter__(self) -> "Admission":
        return self

    def __exit__(self, *exc) -> None:
        self._ctl.release(self._ticket)
