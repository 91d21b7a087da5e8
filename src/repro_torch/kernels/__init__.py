"""Hand-written CUDA kernels for Hopper: the port's counterparts of the
Pallas kernels in the JAX package (``repro.kernels``).

  garble/   half-gates garbling and evaluation with constant-time
            (lookup-free) fixed-key AES, the §7.3 hot loop
  ntt/      negacyclic NTT (forward and inverse) and modular products over
            RNS primes below 2^31, the CKKS hot loop
  paged_attn/  GQA flash-decoding over a paged KV cache's block table:
            decode attention of the serving path (``serve``,
            ``launch.serve --paged``)

Each subpackage: ``csrc/`` (CUDA C++ for ``sm_90a``), ``kernel.py`` (the
``ctypes`` binding, built from the sources on first use by ``_build``),
``ref.py`` (the plain PyTorch version of the same function) and ``ops.py``
(the wrappers the protocol layer calls, with launch counters).

Device selection replaces ``use_pallas()``: a wrapper launches its kernel on
a CUDA tensor and takes the plain version only for a CPU tensor.  Entry
points resolve their ``device`` argument through :func:`resolve_device`,
which picks the card when none is named and raises when there is none; it
never falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without a card);
    ``"cpu"`` -> the CPU, where wrappers run their plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``.  Goes through pinned memory on a
    card, so the copy is asynchronous and never waits for queued kernels."""
    t = torch.from_numpy(np.array(arr, order="C"))    # a copy, never a view
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _pairs(d: dict) -> list:
    """A counter with int or tuple keys as JSON: [[key, count], ...]."""
    return [[k, v] for k, v in d.items()]


def kernel_counts() -> dict:
    """The half-gates and NTT wrappers' counters of this process as JSON
    (launch sizes as [size, count] pairs): what a fleet rank reports and
    the serve daemon's ``status`` carries."""
    from .garble import ops as gc_ops
    from .ntt import ops as ntt_ops
    gc = gc_ops.counts()
    ntt = ntt_ops.counts()
    return {
        "gc": {**{k: gc[k] for k in ("garble_launches", "eval_launches",
                                     "garble_ands", "eval_ands")},
               "launch_sizes": {k: _pairs(v) for k, v in
                                gc["launch_sizes"].items()}},
        "ntt": {**{k: ntt[k] for k in ("launches", "rows", "plain_calls")},
                "launch_sizes": {k: _pairs(v) for k, v in
                                 ntt["launch_sizes"].items()},
                "mul_shapes": _pairs(ntt["mul_shapes"])}}


__all__ = ["kernel_counts", "resolve_device", "to_device"]
