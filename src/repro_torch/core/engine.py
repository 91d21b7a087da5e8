"""MAGE's execution engine (§5, §7.1), on PyTorch: the port's copy of
``repro.core.engine``.

An interpreter for programs in two phases:

* 'memory'  — the planned program: program data lives in one tensor on the
  engine's device, the MAGE-physical address space of ``num_frames``
  pages; swap directives move pages between it, the prefetch buffer and
  the swap storage (``core.storage``: pinned host pages or a swap file).
  A plan without a prefetch buffer keeps synchronous SWAP_IN / SWAP_OUT,
  which run as well.
* 'virtual' — the unbounded baseline: the traced program itself, over a
  tensor of the whole MAGE-virtual address space (``vspace_slots``), with
  no prefetch buffer and no storage; FREE is a no-op and a swap directive
  is an error.

Each instruction's operands are views into the memory tensor; everything
that is not a directive goes to the protocol driver.  Network directives
move spans between workers of the same party over the transport
(``core.transport``): the engine addresses peers by worker id through a
:class:`~repro_torch.core.transport.PartyView`; a program with NET_*
directives and no view raises.  The engine walks an overlap schedule
(``exec.overlap``: sends hoisted, receives posted early and completed
where their data is needed) or a batch schedule (``exec.batching``) when
it is given one, and otherwise the scalar loop: one instruction at a
time, in program order.  All three give the same results bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from .bytecode import (_IMM_OFF, _IN_OFF, _OUT_OFF, Instr, Op, Program,
                       iter_record_chunks, unpack_heads)
from .storage import swap_io
from .transport import PartyView, TransportError, nbytes

if TYPE_CHECKING:
    from ..exec.batching import BatchSchedule
    from ..exec.overlap import OverlapSchedule


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
    #: device bytes the engine allocated: the physical frames plus the
    #: prefetch buffer, or (unbounded) the whole virtual address space
    frame_bytes: int = 0
    net_messages: int = 0
    net_sent_bytes: int = 0
    net_recv_bytes: int = 0
    #: NET_RECVs posted as deferred completion handles (overlap backend)
    posted_recvs: int = 0
    #: peak simultaneously outstanding receive handles (overlap backend)
    max_inflight_recvs: int = 0
    #: per-link totals, (src_worker, dst_worker) -> [messages, bytes]; a
    #: key with src == this worker is outgoing traffic, dst == this worker
    #: incoming.  Counted by the engine thread itself.
    net_links: dict = dataclasses.field(default_factory=dict)

    def _net_count(self, src: int, dst: int, n: int) -> None:
        link = self.net_links.setdefault((src, dst), [0, 0])
        link[0] += 1
        link[1] += n


#: the directives that move pages to and from storage
SWAP_DIRECTIVES = frozenset({Op.SWAP_IN, Op.SWAP_OUT, Op.ISSUE_SWAP_IN,
                             Op.FINISH_SWAP_IN, Op.COPY_OUT,
                             Op.ISSUE_SWAP_OUT, Op.FINISH_SWAP_OUT})


def swapped_pages(prog: Program) -> set[int]:
    """The virtual pages a program ever writes to storage."""
    return {ins.imm[0] for ins in prog.instrs
            if ins.op in (Op.SWAP_OUT, Op.ISSUE_SWAP_OUT)}


class Engine:
    """Interprets one memory- or virtual-phase ``Program`` on ``device``.

    ``storage`` holds the pages the program writes out (unused by a
    virtual program); its owner closes it.  ``net`` is the engine's
    party-scoped view of the transport (NET_* directives).  With a
    ``batch_schedule`` the engine runs the batched path and ``driver`` is
    a batched driver (``exec.base.BatchedProtocolDriver``); an
    ``overlap_schedule`` takes precedence and batches its local groups
    when the driver can; with neither it runs the scalar loop, and any
    driver will do."""

    def __init__(self, program: Program, driver, device: torch.device,
                 storage=None, batch_schedule: BatchSchedule | None = None,
                 net: PartyView | None = None,
                 overlap_schedule: OverlapSchedule | None = None):
        if program.phase not in ("memory", "virtual"):
            raise ValueError(f"expected a memory or virtual program, got "
                             f"phase {program.phase!r}")
        self.prog = program
        self.driver = driver
        self.batch_schedule = batch_schedule
        self.overlap_schedule = overlap_schedule
        self.net = net
        psize = program.page_slots
        if program.phase == "virtual":
            slots = max(program.vspace_slots, 1)
        else:
            slots = max(program.num_frames, 1) * psize
        self.memory = torch.zeros((slots, driver.lane), dtype=driver.dtype,
                                  device=device)
        self.pf = self.io = None
        allocated = self.memory.numel()
        if program.phase == "memory":
            if storage is None:
                raise ValueError("a memory program needs a swap storage")
            self.pf = torch.zeros((max(program.prefetch_slots, 1), psize,
                                   driver.lane), dtype=driver.dtype,
                                  device=device)
            self.io = swap_io(storage, self.pf, device)
            allocated += self.pf.numel()
        self.stats = EngineStats(
            frame_bytes=allocated * self.memory.element_size())

    def _view(self, span) -> torch.Tensor:
        addr, n = span
        return self.memory[addr:addr + n]

    def _net(self) -> PartyView:
        if self.net is None:
            raise TransportError(
                "program has NET_* directives but the engine has no worker "
                "link (pass net=PartyView(...))")
        return self.net

    # -- main loop ---------------------------------------------------------------

    def run(self) -> EngineStats:
        dev = self.memory.device
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                if self.overlap_schedule is not None:
                    self._run_loop_overlap()
                elif self.batch_schedule is not None:
                    self._run_loop()
                else:
                    self._run_scalar()
                if self.io is not None:
                    self.io.flush()
        finally:
            if self.io is not None:
                self.io.close()
                self.stats.io_read_bytes = self.io.bytes_read
                self.stats.io_write_bytes = self.io.bytes_written
        return self.stats

    def _run_scalar(self) -> None:
        """The scalar loop: every instruction through ``_exec_one``, in
        program order."""
        exec_one = self._exec_one
        for instr in self.prog.instrs:
            exec_one(instr)
        self.driver.finalize()

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

    def _net_row(self, ins: Instr, is_send: bool
                 ) -> tuple[int, int, torch.Tensor]:
        """(peer, tag, span view) of a NET_SEND / NET_RECV."""
        span = ins.ins[0] if is_send else ins.outs[0]
        return int(ins.imm[0]), int(ins.imm[1]), self._view(span)

    def _run_loop_overlap(self) -> None:
        """Walk the overlap schedule (``exec.overlap``): NET_SENDs issued
        at their hoisted position, NET_RECVs posted as deferred handles
        (``recv_async``) and completed only at their K_RECV_WAIT group,
        independent local work (batched where the driver can) in between.
        The schedule keeps dataflow and per-channel order, so results
        equal the scalar loop's bit for bit."""
        from ..exec.overlap import K_LOCAL, K_RECV_WAIT, K_SEND
        drv = self.driver
        sched = self.overlap_schedule
        sched.validate_for(self.prog)
        batch_ops = (getattr(drv, "batch_ops", frozenset())
                     if hasattr(drv, "execute_batch") else frozenset())
        order, bounds = sched.order, sched.bounds
        group_kind, group_op = sched.group_kind, sched.group_op
        chunk_groups = sched.chunk_groups
        stats = self.stats
        w = self.prog.worker
        ci = 0
        for start, rec, instrs in iter_record_chunks(self.prog,
                                                     sched.chunk_instrs,
                                                     cache=True):
            handles: dict[int, tuple] = {}
            for g in range(chunk_groups[ci], chunk_groups[ci + 1]):
                rows = order[bounds[g]:bounds[g + 1]]
                kind = int(group_kind[g])
                if kind == K_LOCAL:
                    gop = int(group_op[g])
                    if gop >= 0 and len(rows) >= 2 and rec is not None \
                            and Op(gop) in batch_ops:
                        self._exec_batch(Op(gop), rec, rows)
                    else:
                        for r in rows:
                            self._exec_one(instrs[r])
                elif kind == K_SEND:
                    net = self._net()
                    for r in rows:
                        dst, tag, view = self._net_row(instrs[r], True)
                        net.send_async(w, dst, tag, view)
                        n = nbytes(view)
                        stats.directives += 1
                        stats.net_messages += 1
                        stats.net_sent_bytes += n
                        stats._net_count(w, dst, n)
                elif kind == K_RECV_WAIT:
                    for r in rows:
                        h, src, n = handles.pop(int(r))
                        h.wait()
                        stats.directives += 1
                        stats.net_messages += 1
                        stats.net_recv_bytes += n
                        stats._net_count(src, w, n)
                else:  # K_RECV_POST
                    net = self._net()
                    for r in rows:
                        src, tag, view = self._net_row(instrs[r], False)
                        handles[int(r)] = (
                            net.recv_async(src, w, tag, out=view), src,
                            nbytes(view))
                        stats.posted_recvs += 1
                    if len(handles) > stats.max_inflight_recvs:
                        stats.max_inflight_recvs = len(handles)
            if handles:
                raise AssertionError(
                    f"{len(handles)} receive handles leaked past chunk {ci}")
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
        if io is None and op in SWAP_DIRECTIVES:
            raise ValueError(f"{op.name} in a {self.prog.phase} program: an "
                             f"unbounded run has no swap storage")
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
        elif op == Op.NET_SEND:
            st.directives += 1
            dst, tag = instr.imm[0], instr.imm[1]
            view = self._view(instr.ins[0])
            self._net().send(self.prog.worker, dst, tag, view)
            n = nbytes(view)
            st.net_messages += 1
            st.net_sent_bytes += n
            st._net_count(self.prog.worker, dst, n)
        elif op == Op.NET_RECV:
            st.directives += 1
            src, tag = instr.imm[0], instr.imm[1]
            view = self._view(instr.outs[0])
            self._net().recv(src, self.prog.worker, tag, out=view)
            n = nbytes(view)
            st.net_messages += 1
            st.net_recv_bytes += n
            st._net_count(src, self.prog.worker, n)
        elif op == Op.NET_BARRIER:
            # "wait until the posted send/recv with this tag is done"
            # (bytecode.py): this engine's NET ops complete in place, so
            # there is nothing to wait for; collective sync is the
            # fabric's (PartyView.barrier), not an instruction's
            st.directives += 1
        else:
            st.instructions += 1
            self.driver.execute(op, instr.imm,
                                [self._view(s) for s in instr.outs],
                                [self._view(s) for s in instr.ins])
