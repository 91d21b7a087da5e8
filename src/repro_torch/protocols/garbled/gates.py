"""Batched half-gates garbling/evaluation (ZRE15) with free XOR (KS08), on
PyTorch: the port's counterpart of ``repro.protocols.garbled.gates``.

The garbler and evaluator run the SAME engine/subcircuit code against
different ``Gates`` implementations; every AND call produces/consumes one
garbled-table message streamed over the party channel (§2.4.2 pipelining:
the link is bounded, so the full garbled circuit is never materialized).

Labels are ``(m, 2)`` int64 tensors on the parties' device (bit views of
the uint64 pairs).  Fresh labels and the garbler's R are drawn on the host
from ``numpy.random.default_rng(seed)`` exactly as the JAX package draws
them, then moved to the device, so both packages garble identical circuits
from one seed.  AND gates go through ``kernels.garble.ops``: the CUDA
kernels on a card, their plain versions on the CPU.  OT is simulated
in-process (a trusted OT functionality over the channel).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ...core.transport import Transport, TransportError
from ...kernels import to_device
from ...kernels.garble import ops as garble_ops


@dataclasses.dataclass
class GateCounts:
    ands: int = 0
    xors: int = 0
    consts: int = 0


class PartyChannel:
    """Garbler→evaluator protocol stream over one link of the transport.

    ``src`` and ``dst`` are global ranks: in a job of p workers per party,
    garbler worker k (rank k) streams to evaluator worker k (rank p + k),
    one link per worker pair (the one-to-one inter-party topology of
    Fig. 3).  Each message kind (garbled tables, constants, garbler/evaluator inputs
    via OT, output decode bits) maps to a fixed tag; both parties traverse
    the same bytecode in lockstep, so per-kind FIFO delivery is exactly the
    ordering the protocol needs.  The link's pending set is bounded at
    ``DEPTH`` messages.  ``digest=True`` hashes every table the garbler
    sends (SHA-256, in order), so two runs can prove they streamed the
    same garbled circuit; it copies each table to the host."""

    TAGS = {"tab": 1, "const": 2, "gin": 3, "ot": 4, "dec": 5}

    #: pending messages on the link, the §2.4.2 pipelining bound
    DEPTH = 256
    #: a desynced pair leaves one party waiting on a kind the other never
    #: sends; the timeout turns that deadlock into an error
    RECV_TIMEOUT_S = 600.0

    def __init__(self, transport: Transport, src: int = 0,
                 dst: int = 1, digest: bool = False):
        self.transport = transport
        self.src = src
        self.dst = dst
        transport.set_depth(src, dst, max_msgs=self.DEPTH)
        self.ot_selections = 0
        self._digest = hashlib.sha256() if digest else None

    def send(self, kind: str, t: torch.Tensor) -> None:
        if self._digest is not None and kind == "tab":
            self._digest.update(t.cpu().numpy().tobytes())
        # protocol messages are freshly built and never mutated by the
        # sender afterwards: skip the snapshot on the hot path
        self.transport.send(self.src, self.dst, self.TAGS[kind], t,
                            copy=False)

    def recv(self, kind: str) -> torch.Tensor:
        try:
            return self.transport.recv(self.src, self.dst, self.TAGS[kind],
                                       timeout=self.RECV_TIMEOUT_S)
        except TransportError as e:
            raise TransportError(
                f"party stream: no {kind!r} message on link "
                f"{self.src}->{self.dst} (protocol desync?): {e}") from e

    def table_digest(self) -> str:
        if self._digest is None:
            raise ValueError("channel was built without digest=True")
        return self._digest.hexdigest()


def _mask_np(bits: np.ndarray, lbl: np.ndarray) -> np.ndarray:
    """bits (m,) {0,1} -> bits * lbl, label-wise (host arrays)."""
    return np.where(bits.astype(bool)[:, None], lbl, np.uint64(0))


def lsb(lbl: torch.Tensor) -> torch.Tensor:
    return (lbl[..., 0] & 1).to(torch.uint8)


class Gates:
    """Abstract batched gate interface over label tensors."""

    counts: GateCounts
    device: torch.device

    def xor(self, a, b):
        self.counts.xors += a.numel() // 2
        return a ^ b

    def not_(self, a):
        raise NotImplementedError

    def and_(self, a, b):
        raise NotImplementedError

    def const_bits(self, bits: np.ndarray):
        raise NotImplementedError

    def const_ones(self, m: int):
        return self.const_bits(np.ones(m, dtype=np.uint8))

    def input_garbler(self, bits_or_m):
        raise NotImplementedError

    def input_evaluator(self, bits_or_m):
        raise NotImplementedError

    def output(self, w) -> np.ndarray | None:
        raise NotImplementedError


class GarblerGates(Gates):
    def __init__(self, channel: PartyChannel, device: torch.device,
                 seed: int = 0x4d414745):
        self.ch = channel
        self.device = device
        self.rng = np.random.default_rng(seed)
        self.R = self._fresh_np(1)[0]
        self.R[0] |= np.uint64(1)  # point-and-permute: lsb(Delta) = 1
        self.R_t = to_device(self.R.view(np.int64).reshape(1, 2), device)
        self.R_words = garble_ops.offset(self.R)   # what the kernels take
        self.gid = 0
        self.counts = GateCounts()

    def _fresh_np(self, m: int) -> np.ndarray:
        return self.rng.integers(0, 1 << 63, (m, 2), dtype=np.int64
                                 ).astype(np.uint64)

    def _dev(self, lbl: np.ndarray) -> torch.Tensor:
        return to_device(lbl.view(np.int64), self.device)

    def not_(self, a):
        return a ^ self.R_t

    def and_(self, a, b):
        m = a.shape[0]
        self.counts.ands += m
        c, tab = garble_ops.garble_and(a, b, self.R_words, self.gid)
        self.gid += m
        self.ch.send("tab", tab)
        return c

    def const_bits(self, bits):
        m = len(bits)
        self.counts.consts += m
        zero = self._fresh_np(m)
        self.ch.send("const", self._dev(zero ^ _mask_np(bits, self.R[None])))
        return self._dev(zero)

    def input_garbler(self, bits):
        zero = self._fresh_np(len(bits))
        self.ch.send("gin", self._dev(zero ^ _mask_np(bits, self.R[None])))
        return self._dev(zero)

    def input_evaluator(self, m: int):
        zero = self._fresh_np(m)
        # simulated OT: both labels go to the OT functionality
        self.ch.send("ot", self._dev(np.concatenate([zero, zero ^ self.R],
                                                    axis=1)))
        return self._dev(zero)

    def output(self, w):
        self.ch.send("dec", lsb(w))
        return None


class EvaluatorGates(Gates):
    def __init__(self, channel: PartyChannel, device: torch.device):
        self.ch = channel
        self.device = device
        self.gid = 0
        self.counts = GateCounts()

    def not_(self, a):
        return a

    def and_(self, wa, wb):
        m = wa.shape[0]
        self.counts.ands += m
        tab = self.ch.recv("tab")
        c = garble_ops.eval_and(wa, wb, tab, self.gid)
        self.gid += m
        return c

    def const_bits(self, bits):
        self.counts.consts += len(bits)
        return self.ch.recv("const")

    def input_garbler(self, m: int):
        return self.ch.recv("gin")

    def input_evaluator(self, bits):
        pairs = self.ch.recv("ot")
        self.ch.ot_selections += len(bits)
        sel = to_device(bits.astype(bool), self.device)
        return torch.where(sel[:, None], pairs[:, 2:], pairs[:, :2])

    def output(self, w) -> np.ndarray:
        pbits = self.ch.recv("dec")
        return (lsb(w) ^ pbits).cpu().numpy()
