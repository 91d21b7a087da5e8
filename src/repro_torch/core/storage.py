"""Swap storage and the swap mover of the port's engine (§7.1).

On a card the engine's physical frames and its prefetch buffer live in
device memory, and the swap storage is one pinned host tensor of pages,
so every swap is a DMA copy.  Scheduled swaps (ISSUE_SWAP_IN, COPY_OUT,
ISSUE_SWAP_OUT, FINISH_SWAP_IN) run ``copy_(non_blocking=True)`` on a side
copy stream, ordered against the compute stream by one CUDA event per
prefetch slot in each direction; this takes the place of the JAX package's
``AsyncIO`` thread pool (``repro.core.storage``).  Synchronous SWAP_IN /
SWAP_OUT run on the compute stream after the side stream drains.  On the
CPU every copy is immediate.
"""

from __future__ import annotations

from typing import Callable, Iterable

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

    def page(self, vpage: int) -> torch.Tensor:
        try:
            return self.pages[self.index[vpage]]
        except KeyError:
            raise KeyError(f"page {vpage} has no swap slot: the program "
                           f"never writes it out") from None


class SwapIO:
    """Moves pages between frames, the prefetch buffer ``pf`` and storage.

    Slot discipline on a card: a side-stream copy into or out of ``pf[slot]``
    first waits for the compute stream's last copy of that slot, and a
    compute-stream copy first waits for the side stream's last copy of it.
    Reads and writes of the same storage page are all issued on the side
    stream (or after it drains), so they land in program order."""

    def __init__(self, storage: PinnedStorage, pf: torch.Tensor,
                 device: torch.device):
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

    def close(self) -> None:
        """Wait for every copy in flight: the storage may be freed next."""
        if self.cuda:
            self.side.synchronize()
