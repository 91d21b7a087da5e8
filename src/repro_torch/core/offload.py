"""Memory programming for PyTorch computations: the port's copy of
``repro.core.offload``.

A traced training step is oblivious by construction (no data-dependent
memory accesses), which is the property MAGE exploits for SC.  This module
runs the MAGE planning pipeline over a traced graph's buffer trace:

  * each operation is an instruction; each tensor it makes a
    (variable-sized) page;
  * a backward pass annotates next uses; Belady MIN evicts under a device
    byte budget;
  * the output is an *offload plan*: which buffers to move to host memory
    when, and what traffic that costs under a device<->host bandwidth
    model.

The reference traces a jaxpr (``jaxpr_trace``); here :func:`fx_trace`
traces ``fn`` with ``make_fx`` into an ATen graph.  Its instruction list
cannot equal a jaxpr's (a ``scan`` is one jaxpr equation and many graph
nodes), so it has a contract of its own: every buffer an instruction reads
is an input or was written by an earlier instruction, and every size is
its tensor's bytes.  :func:`plan_offload` is the reference's line for
line, and gives its plan on the same trace.
"""

from __future__ import annotations

import dataclasses
import heapq
import operator
from typing import Callable

import numpy as np
import torch
import torch.fx
from torch import nn

from .bytecode import INF


@dataclasses.dataclass
class BufferTrace:
    sizes: list[int]                  # bytes per buffer id
    reads: list[list[int]]            # per instruction: buffer ids read
    writes: list[list[int]]           # per instruction: buffer ids written
    names: list[str]                  # per instruction: ATen op name


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def graph_trace(graph: torch.fx.Graph) -> BufferTrace:
    """The buffer trace of an ATen graph whose nodes carry their (fake)
    tensors in ``meta["val"]``.  Placeholders and constants (get_attr,
    one buffer a target) are the inputs, numbered first; each other
    call is an instruction reading its tensor arguments and writing one
    buffer an output tensor; ``getitem`` of a multi-output call names that
    call's buffer and is no instruction."""
    sizes: list[int] = []
    ids: dict = {}        # node -> buffer id, or a list of ids (or None)

    def new(val) -> int | None:
        if not isinstance(val, torch.Tensor):
            return None
        sizes.append(_nbytes(val))
        return len(sizes) - 1

    consts: dict[str, int | None] = {}
    for node in graph.nodes:
        if node.op == "placeholder":
            ids[node] = new(node.meta.get("val"))
    for node in graph.nodes:
        if node.op == "get_attr":
            if node.target not in consts:
                consts[node.target] = new(node.meta.get("val"))
            ids[node] = consts[node.target]

    def buffers(arg) -> list[int]:
        out: list[int] = []

        def visit(a):
            got = ids.get(a)
            if isinstance(got, list):
                out.extend(b for b in got if b is not None)
            elif got is not None:
                out.append(got)
            return a
        torch.fx.node.map_arg(arg, visit)
        return out

    reads, writes, names = [], [], []
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        if node.target is operator.getitem:
            src, idx = node.args
            ids[node] = ids[src][idx]
            continue
        val = node.meta.get("val")
        if isinstance(val, (list, tuple)):
            ids[node] = [new(v) for v in val]
            w = [b for b in ids[node] if b is not None]
        else:
            ids[node] = new(val)
            w = [] if ids[node] is None else [ids[node]]
        reads.append(buffers((node.args, node.kwargs)))
        writes.append(w)
        names.append(str(node.target))
    return BufferTrace(sizes, reads, writes, names)


def fx_trace(fn: Callable, *example_args,
             tracing_mode: str = "fake") -> BufferTrace:
    """``make_fx`` of ``fn`` on ``example_args`` -> its buffer trace.  In
    "fake" mode nothing is computed or allocated: a full-width model's
    gradient traces on any host.  Tensors ``fn`` reaches without taking
    them as arguments (a model's buffers) become constants."""
    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(fn, tracing_mode=tracing_mode,
                 _allow_non_fake_inputs=True)(*example_args)
    return graph_trace(gm.graph)


class _Bound(nn.Module):
    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def loss_grad(model: nn.Module, loss: Callable
              ) -> tuple[Callable, dict[str, torch.Tensor]]:
    """(fn, params): ``fn(params, *args)`` is the gradient of the scalar
    ``loss(model, *args)`` with respect to ``params``, the model's
    parameters by name, through ``torch.func``: what :func:`fx_trace`
    traces for a train step (the reference's ``jax.grad``).  torch.func
    takes no checkpointed blocks, so ``loss`` runs without remat."""
    bound = _Bound(model, loss)
    params = dict(bound.named_parameters())

    def fn(p, *args):
        return torch.func.grad(
            lambda q: torch.func.functional_call(bound, q, args))(p)
    return fn, params


@dataclasses.dataclass
class OffloadPlan:
    budget_bytes: int
    peak_unbounded: int               # live bytes at the worst instruction
    bytes_out: int = 0                # device -> host
    bytes_in: int = 0                 # host -> device
    n_offloads: int = 0
    n_reloads: int = 0
    moves: list[tuple[int, str, int, int]] = dataclasses.field(
        default_factory=list)         # (instr, 'out'|'in', buffer, bytes)
    feasible: bool = True

    def est_overhead(self, hbm_host_bw: float = 50e9,
                     compute_s: float | None = None) -> float:
        """Transfer seconds; with compute_s, fraction of step time assuming
        perfect overlap of issue (the prefetch schedule's goal)."""
        xfer = (self.bytes_in + self.bytes_out) / hbm_host_bw
        if compute_s:
            return max(0.0, xfer - compute_s) / compute_s
        return xfer


def plan_offload(trace: BufferTrace, budget_bytes: int) -> OffloadPlan:
    """Belady MIN over the buffer trace with a byte budget."""
    n = len(trace.reads)
    touch = [sorted(set(trace.reads[i]) | set(trace.writes[i]))
             for i in range(n)]
    # next-use annotation (backward pass)
    next_use: list[dict[int, int]] = [dict() for _ in range(n)]
    last: dict[int, int] = {}
    for i in range(n - 1, -1, -1):
        for b in touch[i]:
            next_use[i][b] = last.get(b, INF)
            last[b] = i

    # peak live bytes (for the report)
    first_seen: dict[int, int] = {}
    last_seen: dict[int, int] = {}
    for i in range(n):
        for b in touch[i]:
            first_seen.setdefault(b, i)
            last_seen[b] = i
    delta = np.zeros(n + 1, dtype=np.int64)
    for b, f in first_seen.items():
        delta[f] += trace.sizes[b]
        delta[last_seen[b] + 1] -= trace.sizes[b]
    peak = int(np.max(np.cumsum(delta))) if n else 0

    plan = OffloadPlan(budget_bytes=budget_bytes, peak_unbounded=peak)
    resident: dict[int, int] = {}     # buffer -> bytes
    on_host: set[int] = set()
    cur_bytes = 0
    heap: list[tuple[int, int]] = []  # (-next_use, buffer) lazy
    cur_nu: dict[int, int] = {}

    def pop_victim(pinned: set[int]) -> int | None:
        stash = []
        found = None
        while heap:
            negnu, v = heapq.heappop(heap)
            if v not in resident or cur_nu.get(v) != -negnu:
                continue  # stale
            if v in pinned:
                stash.append((negnu, v))
                continue
            found = v
            break
        for e in stash:
            heapq.heappush(heap, e)
        return found

    for i in range(n):
        pinned = set(touch[i])
        if sum(trace.sizes[b] for b in pinned) > budget_bytes:
            plan.feasible = False  # one instruction exceeds the budget
        for b in pinned:
            if b not in resident:
                sz = trace.sizes[b]
                while cur_bytes + sz > budget_bytes:
                    victim = pop_victim(pinned)
                    if victim is None:
                        break
                    cur_bytes -= resident.pop(victim)
                    if cur_nu.get(victim, INF) < INF:
                        plan.bytes_out += trace.sizes[victim]
                        plan.n_offloads += 1
                        plan.moves.append((i, "out", victim,
                                           trace.sizes[victim]))
                        on_host.add(victim)
                if b in on_host:
                    plan.bytes_in += sz
                    plan.n_reloads += 1
                    plan.moves.append((i, "in", b, sz))
                    on_host.discard(b)
                resident[b] = sz
                cur_bytes += sz
            nu = next_use[i][b]
            cur_nu[b] = nu
            heapq.heappush(heap, (-nu, b))
    return plan
