#!/usr/bin/env python3
"""The host's time for the pieces of a garbled-circuit subcircuit on one
card, and three small two-party jobs whose ops make many small AND calls.

    python3 tools/gc_host_costs.py

Each piece is timed on the host's clock over 2000 back-to-back calls on
the garbler's side (labels of 32 elements on the card), synchronised at
both ends: a draw from the garbler's generator, a copy of 32 labels to the
card through pinned memory and through pageable memory, ``const_bits``,
one XOR, one concatenation, one AND call (two contiguous copies of its
operands and the garble wrapper), an add of two 2-bit values, a
zero-extension from 1 to 2 bits, a message through the party channel,
and a stack of two values transposed for the carry chain.  Then
binfclayer n=512, mvmul n=96 and ljoin n=64 unbounded, two-party on the
batched loop, checked against the oracle: execute s and AND gates.  It
prints one line per figure.  Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.api import JobSpec, Session  # noqa: E402
from repro_torch.core.transport import InprocTransport  # noqa: E402
from repro_torch.kernels import to_device  # noqa: E402
from repro_torch.protocols.garbled.engineops import AndXorOps  # noqa: E402
from repro_torch.protocols.garbled.gates import (GarblerGates,  # noqa: E402
                                                 PartyChannel)

JOBS = [("binfclayer", 512), ("mvmul", 96), ("ljoin", 64)]


def _us(name: str, fn, reps: int = 2000) -> None:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    print(f"{name}: {(time.perf_counter() - t0) / reps * 1e6:.1f} us",
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("gc_host_costs: no CUDA device")
    dev = torch.device("cuda", 0)
    transport = InprocTransport(2)
    ch = PartyChannel(transport)
    transport.set_depth(0, 1, max_msgs=0)     # one thread: no bound
    g = GarblerGates(ch, dev, seed=7)
    o = AndXorOps(g)
    zeros = np.zeros(32, np.uint8)
    a = g.const_bits(zeros)[:, None, :].expand(32, 2, 2).contiguous()
    b = a.clone()
    bit = a[:, :1].contiguous()
    host = np.zeros((32, 2), np.int64)
    _us("draw from the generator", lambda: g._fresh_np(32))
    _us("to_device (pinned), 32 labels", lambda: to_device(host, dev))
    _us("torch.tensor (pageable), 32 labels",
        lambda: torch.tensor(host, device=dev))
    _us("const_bits", lambda: g.const_bits(zeros))
    _us("xor", lambda: a ^ b)
    _us("cat", lambda: torch.cat([a, b], 1))
    _us("and_ (32 gates)", lambda: g.and_(a[:, 0].contiguous(),
                                          b[:, 0].contiguous()))
    _us("add of 2-bit values", lambda: o.add(a, b))
    _us("zext 1 -> 2 bits", lambda: o._zext(bit, 2))
    _us("send + recv", lambda: (ch.send("tab", a), ch.recv("tab")))
    _us("stack + permute + contiguous",
        lambda: torch.stack([a, b]).permute(2, 0, 1, 3).contiguous())
    for wl, n in JOBS:
        s = Session(JobSpec(wl, n=n, plan_mode="unbounded"), device=dev)
        s.execute(real=True, check=True)
        print(f"{wl} n={n} unbounded: execute {s.timings['execute_s']:.3f} "
              f"s, {s.gate_counts[0].ands} AND gates", flush=True)
    print(torch.cuda.get_device_name(0), flush=True)


if __name__ == "__main__":
    main()
