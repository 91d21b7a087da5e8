"""The tracing DSL core (§6.2.1).

MAGE's DSLs are "internal" languages: the user writes an ordinary function;
executing it does NOT perform secure computation, it *emits bytecode*.  Our
analogue is a Python tracing context: protocol packages define value types
(garbled ``Integer`` vectors, CKKS ``Batch``es) whose overloaded operators
call ``Builder.emit``.  Deallocation requests reach the placement allocator
when a value's refcount drops (CPython destructors — the analogue of C++
destructors in the paper) or via explicit ``free()``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence

from .bytecode import Instr, Op, Program, Span
from .placement import PageAllocator

_tls = threading.local()


def current_builder() -> "Builder":
    b = getattr(_tls, "builder", None)
    if b is None:
        raise RuntimeError("no active Builder; use `with Builder(...)`")
    return b


class Builder:
    """Accumulates bytecode for ONE worker while the DSL program executes."""

    def __init__(self, protocol: str, page_shift: int,
                 worker: int = 0, num_workers: int = 1):
        self.protocol = protocol
        self.page_shift = page_shift
        self.worker = worker
        self.num_workers = num_workers
        self.alloc = PageAllocator(page_shift)
        self.instrs: list[Instr] = []
        self._closed = False
        self._net_tag = 0

    # -- context management ---------------------------------------------------

    def __enter__(self) -> "Builder":
        if getattr(_tls, "builder", None) is not None:
            raise RuntimeError("Builder contexts do not nest")
        _tls.builder = self
        return self

    def __exit__(self, *exc) -> None:
        _tls.builder = None

    # -- emission ---------------------------------------------------------------

    def emit(self, op: Op, outs: Sequence[Span] = (), ins: Sequence[Span] = (),
             imm: tuple = ()) -> None:
        if self._closed:
            raise RuntimeError("builder already finished")
        self.instrs.append(Instr(op, tuple(outs), tuple(ins), tuple(imm)))

    def new_span(self, n_slots: int) -> Span:
        return (self.alloc.alloc(n_slots), n_slots)

    def free_span(self, span: Span) -> None:
        if self._closed:
            return  # program over; allocator bookkeeping no longer matters
        self.alloc.free(span[0])
        self.emit(Op.FREE, ins=(span,))

    def fresh_tag(self) -> int:
        self._net_tag += 1
        return self._net_tag

    # -- finish -----------------------------------------------------------------

    def finish(self, meta: dict | None = None) -> Program:
        self._closed = True
        return Program(
            instrs=self.instrs,
            page_shift=self.page_shift,
            protocol=self.protocol,
            phase="virtual",
            worker=self.worker,
            num_workers=self.num_workers,
            vspace_slots=self.alloc.vspace_slots,
            meta=dict(meta or {}),
        )


class Value:
    """Base class for DSL values: owns one ≤page-sized span of slots."""

    __slots__ = ("builder", "span", "_freed", "__weakref__")

    def __init__(self, n_slots: int, builder: Builder | None = None):
        self.builder = builder or current_builder()
        self.span = self.builder.new_span(n_slots)
        self._freed = False

    @property
    def addr(self) -> int:
        return self.span[0]

    @property
    def n_slots(self) -> int:
        return self.span[1]

    def free(self) -> None:
        if not self._freed:
            self._freed = True
            self.builder.free_span(self.span)

    def __del__(self):
        with contextlib.suppress(Exception):
            self.free()


def trace(fn: Callable[..., None], *, protocol: str, page_shift: int,
          worker: int = 0, num_workers: int = 1,
          args: tuple = (), kwargs: dict | None = None,
          meta: dict | None = None) -> Program:
    """Run a DSL program function and return its virtual-address bytecode."""
    import gc
    b = Builder(protocol, page_shift, worker=worker, num_workers=num_workers)
    with b:
        fn(*args, **(kwargs or {}))
        gc.collect()  # flush destructor-driven FREEs before closing
    return b.finish(meta)
