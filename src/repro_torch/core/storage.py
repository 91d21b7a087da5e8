"""Swap storage and the swap movers of the port's engine (§7.1).

On a card the engine's physical frames and its prefetch buffer live in
device memory.  Two storages hold the pages a program writes out, as in
the JAX package (``repro.core.storage``):

* ``PinnedStorage`` ("ram"): one pinned host tensor of pages, so every
  swap is a DMA copy.  Its mover, :class:`SwapIO`, runs scheduled swaps
  (ISSUE_SWAP_IN, COPY_OUT, ISSUE_SWAP_OUT, FINISH_SWAP_IN) as
  ``copy_(non_blocking=True)`` on a side copy stream, ordered against the
  compute stream by one CUDA event per prefetch slot in each direction;
  synchronous SWAP_IN / SWAP_OUT run on the compute stream after the side
  stream drains.
* ``MemmapStorage`` ("memmap"): a temporary swap file under ``np.memmap``.
  Its mover, :class:`FileSwapIO`, stages each page in a host bounce page
  (pinned on a card) and runs the file reads and writes on a small thread
  pool, the JAX package's ``AsyncIO``.

On the CPU every device copy is immediate.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import tempfile
from typing import Callable, Iterable

import numpy as np
import torch


class PinnedStorage:
    """One page per MAGE-virtual page the program writes out, in a single
    host tensor (pinned when the engine runs on a card)."""

    def __init__(self, vpages: Iterable[int], page_shape: tuple[int, ...],
                 dtype: torch.dtype, device: torch.device):
        pages = sorted(set(vpages))
        self.index = {v: k for k, v in enumerate(pages)}
        self.pages = torch.empty((max(len(pages), 1), *page_shape),
                                 dtype=dtype,
                                 pin_memory=device.type == "cuda")
        self.page_bytes = self.pages[0].numel() * self.pages.element_size()

    def row(self, vpage: int) -> int:
        """The storage row of a MAGE-virtual page."""
        try:
            return self.index[vpage]
        except KeyError:
            raise KeyError(f"page {vpage} has no swap slot: the program "
                           f"never writes it out") from None

    def page(self, vpage: int) -> torch.Tensor:
        return self.pages[self.row(vpage)]

    def close(self) -> None:
        pass


class MemmapStorage:
    """A swap file: one row per MAGE-virtual page the program writes out,
    in a temporary file (``mage_swap_*.bin``) under ``np.memmap``, flushed
    and unlinked at close.  Rows are read and written from the I/O threads
    of :class:`FileSwapIO`, never two at once on one row."""

    def __init__(self, vpages: Iterable[int], page_shape: tuple[int, ...],
                 dtype: torch.dtype, device: torch.device):
        pages = sorted(set(vpages))
        self.index = {v: k for k, v in enumerate(pages)}
        self.page_shape = tuple(page_shape)
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        self.page_bytes = int(np.prod(page_shape)) * np_dtype.itemsize
        fd, self.path = tempfile.mkstemp(prefix="mage_swap_", suffix=".bin")
        self._mm: np.memmap | None = None
        try:
            os.ftruncate(fd, len(pages) * self.page_bytes)
            os.close(fd)
            fd = -1
            if pages:
                self._mm = np.memmap(self.path, dtype=np_dtype, mode="r+",
                                     shape=(len(pages), *self.page_shape))
        except BaseException:
            if fd >= 0:
                os.close(fd)
            self.close()
            raise

    row = PinnedStorage.row

    def read(self, vpage: int, out: np.ndarray) -> None:
        out[...] = self._mm[self.row(vpage)]

    def write(self, vpage: int, data: np.ndarray) -> None:
        self._mm[self.row(vpage)] = data

    def close(self) -> None:
        """Flush and unlink the file; safe to call more than once."""
        if self._mm is not None:
            self._mm.flush()
            self._mm = None
        if os.path.exists(self.path):
            os.unlink(self.path)


class SwapIO:
    """Moves pages between frames, the prefetch buffer ``pf`` and storage.

    Slot discipline on a card: a side-stream copy into or out of ``pf[slot]``
    first waits for the compute stream's last copy of that slot, and a
    compute-stream copy first waits for the side stream's last copy of it.
    Reads and writes of the same storage page are all issued on the side
    stream (or after it drains), so they land in program order."""

    def __init__(self, storage, pf: torch.Tensor, device: torch.device):
        self.storage = storage
        self.pf = pf
        self.cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self._side_done: list = [None] * pf.shape[0]
        self._main_done: list = [None] * pf.shape[0]
        self.bytes_read = 0
        self.bytes_written = 0

    def _on_side(self, slot: int, copy: Callable[[], None]) -> None:
        if not self.cuda:
            copy()
            return
        if self._main_done[slot] is not None:
            self.side.wait_event(self._main_done[slot])
        with torch.cuda.stream(self.side):
            copy()
            self._side_done[slot] = torch.cuda.Event()
            self._side_done[slot].record(self.side)

    def _on_main(self, slot: int, copy: Callable[[], None]) -> None:
        if not self.cuda:
            copy()
            return
        main = torch.cuda.current_stream()
        if self._side_done[slot] is not None:
            main.wait_event(self._side_done[slot])
        copy()
        self._main_done[slot] = torch.cuda.Event()
        self._main_done[slot].record(main)

    # -- scheduled (asynchronous) swaps ---------------------------------------

    def issue_read(self, vpage: int, slot: int) -> None:
        self.bytes_read += self.storage.page_bytes
        src, dst = self.storage.page(vpage), self.pf[slot]
        self._on_side(slot, lambda: dst.copy_(src, non_blocking=True))

    def finish_read(self, slot: int, frame: torch.Tensor) -> None:
        src = self.pf[slot]
        self._on_main(slot, lambda: frame.copy_(src, non_blocking=True))

    def copy_out(self, slot: int, frame: torch.Tensor) -> None:
        dst = self.pf[slot]
        self._on_main(slot, lambda: dst.copy_(frame, non_blocking=True))

    def issue_write(self, vpage: int, slot: int) -> None:
        self.bytes_written += self.storage.page_bytes
        src, dst = self.pf[slot], self.storage.page(vpage)
        self._on_side(slot, lambda: dst.copy_(src, non_blocking=True))

    # -- synchronous swaps (replacement-only plans, degraded evictions) ------

    def _sync(self, copy: Callable[[], None]) -> None:
        if not self.cuda:
            copy()
            return
        main = torch.cuda.current_stream()
        main.wait_stream(self.side)
        copy()
        self.side.wait_stream(main)

    def read_sync(self, vpage: int, frame: torch.Tensor) -> None:
        self.bytes_read += self.storage.page_bytes
        src = self.storage.page(vpage)
        self._sync(lambda: frame.copy_(src, non_blocking=True))

    def write_sync(self, vpage: int, frame: torch.Tensor) -> None:
        self.bytes_written += self.storage.page_bytes
        dst = self.storage.page(vpage)
        self._sync(lambda: dst.copy_(frame, non_blocking=True))

    def flush(self) -> None:
        """Wait for every copy in flight."""
        if self.cuda:
            self.side.synchronize()

    def close(self) -> None:
        """Wait for every copy in flight: the storage may be freed next."""
        self.flush()


class FileSwapIO(SwapIO):
    """Moves pages between frames, the prefetch buffer ``pf`` and a swap
    file (:class:`MemmapStorage`).

    A page travels between the device and the file through a host bounce
    page: one per prefetch slot, and one for synchronous swaps.  File
    reads and writes run on ``threads`` I/O threads, in this order:

    * a file write starts only after the device-to-host copy into its
      bounce page has completed (the task waits on the copy's event);
    * a host-to-device copy out of a bounce page is enqueued only after the
      file read into it has finished (``finish_read`` waits for the read);
    * the file operations on one storage page, and those on one bounce
      page, run in program order: each waits for the previous one, which
      was submitted earlier and so has a thread already;
    * ``flush`` waits for everything in flight and raises an I/O error,
      ``close`` drains quietly.

    A scheduled write's bounce page is taken after COPY_OUT has put the
    page in ``pf[slot]``, so a bypassed read (FINISH_SWAP_IN of a slot
    whose write is pending) still copies from ``pf[slot]``."""

    def __init__(self, storage: MemmapStorage, pf: torch.Tensor,
                 device: torch.device, threads: int = 2):
        super().__init__(storage, pf, device)
        n = pf.shape[0]
        self.sync_slot = n
        self.bounce = torch.empty((n + 1, *pf.shape[1:]), dtype=pf.dtype,
                                  pin_memory=self.cuda)
        self._host = self.bounce.numpy()
        self.pool = cf.ThreadPoolExecutor(max_workers=threads,
                                          thread_name_prefix="mage-io")
        self._slot_op: list[cf.Future | None] = [None] * (n + 1)
        self._page_op: dict[int, cf.Future] = {}
        #: the last device copy out of each bounce page (a card only)
        self._bounce_read: list = [None] * (n + 1)
        #: the slot's data waits in its bounce page (a read), not in pf
        self._staged = [False] * n

    def _submit(self, slot: int, vpage: int, fn: Callable[[], None],
                after=None) -> cf.Future:
        """Run ``fn`` on an I/O thread once the previous file operations
        on bounce page ``slot`` and on ``vpage`` are done and the CUDA
        event ``after`` has completed."""
        deps = [f for f in (self._slot_op[slot], self._page_op.get(vpage))
                if f is not None]

        def task() -> None:
            for f in deps:
                f.result()
            if after is not None:
                after.synchronize()
            fn()

        fut = self.pool.submit(task)
        self._slot_op[slot] = self._page_op[vpage] = fut
        return fut

    def _read_file(self, vpage: int, slot: int) -> cf.Future:
        self.storage.row(vpage)
        self.bytes_read += self.storage.page_bytes
        out = self._host[slot]
        return self._submit(slot, vpage,
                            lambda: self.storage.read(vpage, out),
                            after=self._bounce_read[slot])

    def _write_file(self, vpage: int, slot: int, copied) -> cf.Future:
        data = self._host[slot]
        return self._submit(slot, vpage,
                            lambda: self.storage.write(vpage, data),
                            after=copied)

    def _unstage(self, slot: int, frame: torch.Tensor) -> None:
        """Copy bounce page ``slot`` into ``frame`` once its read is in."""
        self._slot_op[slot].result()
        frame.copy_(self.bounce[slot], non_blocking=self.cuda)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream())
            self._bounce_read[slot] = ev

    def _take_bounce(self, slot: int) -> None:
        """Wait until no file operation uses bounce page ``slot``."""
        if self._slot_op[slot] is not None:
            self._slot_op[slot].result()

    # -- scheduled (asynchronous) swaps ---------------------------------------

    def issue_read(self, vpage: int, slot: int) -> None:
        self._read_file(vpage, slot)
        self._staged[slot] = True

    def finish_read(self, slot: int, frame: torch.Tensor) -> None:
        if not self._staged[slot]:      # bypassed: the page is in pf[slot]
            super().finish_read(slot, frame)
            return
        self._staged[slot] = False
        self._unstage(slot, frame)

    def copy_out(self, slot: int, frame: torch.Tensor) -> None:
        self._staged[slot] = False
        super().copy_out(slot, frame)

    def issue_write(self, vpage: int, slot: int) -> None:
        self.storage.row(vpage)
        self.bytes_written += self.storage.page_bytes
        self._take_bounce(slot)
        src, dst = self.pf[slot], self.bounce[slot]
        if not self.cuda:
            dst.copy_(src)
            self._write_file(vpage, slot, None)
            return
        before = self._bounce_read[slot]

        def copy() -> None:
            if before is not None:
                self.side.wait_event(before)
            dst.copy_(src, non_blocking=True)

        self._on_side(slot, copy)
        self._write_file(vpage, slot, self._side_done[slot])

    # -- synchronous swaps ----------------------------------------------------

    def read_sync(self, vpage: int, frame: torch.Tensor) -> None:
        self._read_file(vpage, self.sync_slot)
        self._unstage(self.sync_slot, frame)

    def write_sync(self, vpage: int, frame: torch.Tensor) -> None:
        s = self.sync_slot
        self.storage.row(vpage)
        self.bytes_written += self.storage.page_bytes
        self._take_bounce(s)
        self.bounce[s].copy_(frame, non_blocking=self.cuda)
        copied = None
        if self.cuda:
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream())
        self._write_file(vpage, s, copied).result()

    def flush(self) -> None:
        for fut in list(self._page_op.values()):
            fut.result()
        super().flush()

    def close(self) -> None:
        self.pool.shutdown(wait=True)
        super().flush()


def swap_io(storage, pf: torch.Tensor, device: torch.device) -> SwapIO:
    """The mover for a storage: :class:`FileSwapIO` for a swap file,
    :class:`SwapIO` for pinned pages."""
    if isinstance(storage, MemmapStorage):
        return FileSwapIO(storage, pf, device)
    return SwapIO(storage, pf, device)
