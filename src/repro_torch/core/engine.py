"""MAGE's execution engine (§5, §7.1), on PyTorch: the port's copy of
``repro.core.engine`` for one worker per party.

An interpreter for memory programs, walked in the order of their batch
schedule (``exec.batching``).  Program data lives in one tensor on the
engine's device, the MAGE-physical address space of ``num_frames`` pages:
each instruction's operands are views into it, swap directives move pages
between it, the prefetch buffer and pinned host storage (``core.storage``),
and everything else is delegated to the protocol driver.  A plan without a
prefetch buffer keeps synchronous SWAP_IN / SWAP_OUT, which run as well.
The unbounded (virtual-phase) run, the scalar loop and NET_* directives
(multi-worker jobs) wait for later slices.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from .bytecode import (_IMM_OFF, _IN_OFF, _OUT_OFF, Instr, Op, Program,
                       iter_record_chunks, unpack_heads)
from .storage import PinnedStorage, SwapIO

if TYPE_CHECKING:
    from ..exec.batching import BatchSchedule


class ProtocolDriver:
    """Lower layer of the interpreter (§4.3): executes ops with the SC scheme.

    ``lane``/``dtype`` define the memory tensor's slot layout; the garbled
    circuit driver uses lane=2, int64 (one 128-bit wire label per slot).
    Drivers keep all state *inside the spans* they are handed, which is what
    makes engine-level swapping sound (§7.1).
    """

    lane: int = 1
    dtype: torch.dtype = torch.int64
    name: str = "abstract"

    def execute(self, op: Op, imm: tuple, outs: list[torch.Tensor],
                ins: list[torch.Tensor]) -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        pass


@dataclasses.dataclass
class EngineStats:
    instructions: int = 0
    directives: int = 0
    swap_ins: int = 0            # pages read from storage
    swap_outs: int = 0           # pages written to storage
    io_read_bytes: int = 0
    io_write_bytes: int = 0
    finish_in_waits: int = 0
    finish_out_waits: int = 0
    #: instructions executed through driver.execute_batch, and the number
    #: of execute_batch calls they collapsed into
    batched_instructions: int = 0
    batches: int = 0
    #: device bytes of the physical frames plus the prefetch buffer
    frame_bytes: int = 0


def swapped_pages(prog: Program) -> set[int]:
    """The virtual pages a program ever writes to storage."""
    return {ins.imm[0] for ins in prog.instrs
            if ins.op in (Op.SWAP_OUT, Op.ISSUE_SWAP_OUT)}


class Engine:
    """Interprets one memory-phase ``Program`` on ``device``; ``driver``
    is a batched driver (``exec.base.BatchedProtocolDriver``)."""

    def __init__(self, program: Program, driver, device: torch.device,
                 batch_schedule: BatchSchedule):
        if program.phase != "memory":
            raise ValueError(f"expected a memory program, got phase "
                             f"{program.phase!r}")
        self.prog = program
        self.driver = driver
        self.batch_schedule = batch_schedule
        psize = program.page_slots
        self.memory = torch.zeros((max(program.num_frames, 1) * psize,
                                   driver.lane), dtype=driver.dtype,
                                  device=device)
        self.pf = torch.zeros((max(program.prefetch_slots, 1), psize,
                               driver.lane), dtype=driver.dtype,
                              device=device)
        storage = PinnedStorage(swapped_pages(program), (psize, driver.lane),
                                driver.dtype, device)
        self.io = SwapIO(storage, self.pf, device)
        self.stats = EngineStats(frame_bytes=(
            self.memory.numel() + self.pf.numel()) * self.memory.element_size())

    def _view(self, span) -> torch.Tensor:
        addr, n = span
        return self.memory[addr:addr + n]

    # -- main loop ---------------------------------------------------------------

    def run(self) -> EngineStats:
        dev = self.memory.device
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                self._run_loop()
        finally:
            self.io.close()
            self.stats.io_read_bytes = self.io.bytes_read
            self.stats.io_write_bytes = self.io.bytes_written
        return self.stats

    def _run_loop(self) -> None:
        """Walk the precomputed batch schedule.

        Batchable groups (same op, uniform shape, mutually independent;
        see exec/batching.py) go through ``driver.execute_batch`` as
        gathered span columns; everything else — barriers, ops outside
        the driver's ``batch_ops``, singleton groups — replays through
        ``_exec_one`` in schedule order."""
        drv = self.driver
        sched = self.batch_schedule
        sched.validate_for(self.prog)
        batch_ops = getattr(drv, "batch_ops", frozenset())
        order, bounds = sched.order, sched.bounds
        group_op, chunk_groups = sched.group_op, sched.chunk_groups
        ci = 0
        for start, rec, instrs in iter_record_chunks(self.prog,
                                                     sched.chunk_instrs,
                                                     cache=True):
            for g in range(chunk_groups[ci], chunk_groups[ci + 1]):
                rows = order[bounds[g]:bounds[g + 1]]
                gop = int(group_op[g])
                if gop >= 0 and len(rows) >= 2 and rec is not None \
                        and Op(gop) in batch_ops:
                    self._exec_batch(Op(gop), rec, rows)
                else:
                    for r in rows:
                        self._exec_one(instrs[r])
            ci += 1
        drv.finalize()

    def _exec_batch(self, op: Op, rec: np.ndarray, rows: np.ndarray) -> None:
        r0 = rec[rows[0]]
        _, n_outs, n_ins, n_imm = unpack_heads(r0[0])
        imm = tuple(int(r0[_IMM_OFF + j]) for j in range(n_imm))
        out_idx = [(rec[rows, _OUT_OFF + 2 * j],
                    int(r0[_OUT_OFF + 1 + 2 * j])) for j in range(n_outs)]
        in_idx = [(rec[rows, _IN_OFF + 2 * j],
                   int(r0[_IN_OFF + 1 + 2 * j])) for j in range(n_ins)]
        self.driver.execute_batch(op, imm, out_idx, in_idx, self.memory)
        self.stats.instructions += len(rows)
        self.stats.batched_instructions += len(rows)
        self.stats.batches += 1

    def _exec_one(self, instr: Instr) -> None:
        op = instr.op
        st = self.stats
        io = self.io
        if op == Op.SWAP_IN:
            st.directives += 1
            st.swap_ins += 1
            io.read_sync(instr.imm[0], self._view(instr.outs[0]))
        elif op == Op.SWAP_OUT:
            st.directives += 1
            st.swap_outs += 1
            io.write_sync(instr.imm[0], self._view(instr.ins[0]))
        elif op == Op.ISSUE_SWAP_IN:
            st.directives += 1
            st.swap_ins += 1
            io.issue_read(instr.imm[0], instr.imm[1])
        elif op == Op.FINISH_SWAP_IN:
            st.directives += 1
            st.finish_in_waits += 1
            io.finish_read(instr.imm[1], self._view(instr.outs[0]))
        elif op == Op.COPY_OUT:
            st.directives += 1
            io.copy_out(instr.imm[0], self._view(instr.ins[0]))
        elif op == Op.ISSUE_SWAP_OUT:
            st.directives += 1
            st.swap_outs += 1
            io.issue_write(instr.imm[0], instr.imm[1])
        elif op == Op.FINISH_SWAP_OUT:
            # the per-slot events already order every later use of the
            # slot after the write; nothing has to wait here
            st.directives += 1
            st.finish_out_waits += 1
        elif op == Op.FREE:
            pass
        elif op in (Op.NET_SEND, Op.NET_RECV, Op.NET_BARRIER):
            raise NotImplementedError(
                "NET_* directives (multi-worker jobs) are not ported yet")
        else:
            st.instructions += 1
            self.driver.execute(op, instr.imm,
                                [self._view(s) for s in instr.outs],
                                [self._view(s) for s in instr.ins])
