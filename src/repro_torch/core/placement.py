"""MAGE planner stage 1: placement (§6.2).

A page-aware slab allocator for the DSL: each MAGE-virtual page holds values
of a single size class, values never straddle pages, and among pages of the
right class with free slots we pick the one with the FEWEST free slots
(§6.2.2's effective-fragmentation heuristic: give whole pages a chance to
die).  Page-sized values get dedicated pages.
"""

from __future__ import annotations

import dataclasses
import heapq


@dataclasses.dataclass
class _SlabClass:
    size: int                      # slots per value
    capacity: int                  # values per page
    # page -> sorted free slot indices (list used as LIFO for locality)
    free_slots: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    # lazy min-heap of (free_count, page) candidates; stale entries skipped
    heap: list[tuple[int, int]] = dataclasses.field(default_factory=list)


class PageAllocator:
    """Slab allocator over the MAGE-virtual address space (slot-addressed)."""

    def __init__(self, page_shift: int):
        self.page_shift = page_shift
        self.page_slots = 1 << page_shift
        self._next_page = 0
        self._classes: dict[int, _SlabClass] = {}
        self._span_size: dict[int, int] = {}   # base addr -> n_slots
        self._page_class: dict[int, int] = {}  # page -> size class
        self.stats = {"allocs": 0, "frees": 0, "pages": 0,
                      "slab_wasted_slots": 0}

    # -- helpers -------------------------------------------------------------

    def _new_page(self) -> int:
        p = self._next_page
        self._next_page += 1
        self.stats["pages"] += 1
        return p

    def num_pages(self) -> int:
        return self._next_page

    @property
    def vspace_slots(self) -> int:
        return self._next_page << self.page_shift

    def size_of(self, addr: int) -> int:
        return self._span_size[addr]

    # -- alloc/free ------------------------------------------------------------

    def alloc(self, n_slots: int) -> int:
        if n_slots <= 0:
            raise ValueError(f"alloc of {n_slots} slots")
        if n_slots > self.page_slots:
            raise ValueError(
                f"value of {n_slots} slots exceeds the page size "
                f"({self.page_slots} slots); values must not straddle pages — "
                f"chunk the value at the DSL/library level")
        self.stats["allocs"] += 1
        if n_slots == self.page_slots:
            page = self._new_page()
            addr = page << self.page_shift
            self._span_size[addr] = n_slots
            return addr

        cls = self._classes.get(n_slots)
        if cls is None:
            cap = self.page_slots // n_slots
            cls = _SlabClass(size=n_slots, capacity=cap)
            self._classes[n_slots] = cls
            self.stats["slab_wasted_slots"] += 0

        # fewest-free-slots page with a free slot (lazy heap)
        page = None
        while cls.heap:
            cnt, cand = cls.heap[0]
            cur = cls.free_slots.get(cand)
            if cur is None or len(cur) != cnt or len(cur) == 0:
                heapq.heappop(cls.heap)  # stale
                continue
            page = cand
            break
        if page is None:
            page = self._new_page()
            self._page_class[page] = n_slots
            cls.free_slots[page] = list(range(cls.capacity - 1, -1, -1))
            self.stats["slab_wasted_slots"] += (
                self.page_slots - cls.capacity * n_slots)
        slots = cls.free_slots[page]
        idx = slots.pop()
        if slots:
            heapq.heappush(cls.heap, (len(slots), page))
        addr = (page << self.page_shift) + idx * n_slots
        self._span_size[addr] = n_slots
        return addr

    def free(self, addr: int) -> None:
        n = self._span_size.pop(addr, None)
        if n is None:
            raise KeyError(f"double free or bad free at {addr}")
        self.stats["frees"] += 1
        if n == self.page_slots:
            return  # dedicated page simply dies
        page = addr >> self.page_shift
        cls = self._classes[n]
        idx = (addr - (page << self.page_shift)) // n
        slots = cls.free_slots[page]
        slots.append(idx)
        heapq.heappush(cls.heap, (len(slots), page))

    def live_slots(self) -> int:
        return sum(self._span_size.values())
