"""The half-gates wrappers the protocol layer calls, with launch counters.

Labels are ``(m, 2)`` int64 tensors (bit views of the uint64 pairs) and
tables ``(m, 4)`` int64 laid out ``[TG | TE]``, the message of the NumPy
gates.  On a CUDA tensor a wrapper launches its kernel on the current
stream (no synchronisation, outputs allocated here); on a CPU tensor it
runs the plain version in ``ref.py``; on anything else it raises.  The
counters count kernel launches only, so a run can show that its ANDs went
through the kernels.
"""

from __future__ import annotations

import threading
from collections import Counter

import numpy as np
import torch

from . import kernel, ref

_lock = threading.Lock()
garble_launches = 0
eval_launches = 0
garble_ands = 0          # AND gates garbled by the kernel
eval_ands = 0            # AND gates evaluated by the kernel
launch_sizes: dict[str, Counter] = {"garble": Counter(), "eval": Counter()}


def reset_counts() -> None:
    global garble_launches, eval_launches, garble_ands, eval_ands
    with _lock:
        garble_launches = eval_launches = garble_ands = eval_ands = 0
        for c in launch_sizes.values():
            c.clear()


def counts() -> dict:
    with _lock:
        return {"garble_launches": garble_launches,
                "eval_launches": eval_launches,
                "garble_ands": garble_ands, "eval_ands": eval_ands,
                "launch_sizes": {k: dict(v) for k, v in launch_sizes.items()}}


def _count(kind: str, m: int) -> None:
    global garble_launches, eval_launches, garble_ands, eval_ands
    with _lock:
        if kind == "garble":
            garble_launches += 1
            garble_ands += m
        else:
            eval_launches += 1
            eval_ands += m
        launch_sizes[kind][m] += 1


def _check(t: torch.Tensor, name: str, cols: int, m: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int64 or t.shape != (m, cols):
        raise ValueError(f"{name} must be ({m}, {cols}) int64, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_gid(gid0: int, m: int) -> None:
    if not (0 <= gid0 and gid0 + m < 1 << 62):
        raise ValueError(f"gate ids [{gid0}, {gid0 + m}) out of range")


def garble_and(a: torch.Tensor, b: torch.Tensor, r: np.ndarray,
               gid0: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Garble m AND gates with ids gid0.. under the global offset ``r``
    ((2,) uint64, the garbler's R).  Returns (c0 (m, 2), tab (m, 4))."""
    m = a.shape[0] if isinstance(a, torch.Tensor) and a.dim() else -1
    dev = a.device
    _check(a, "a", 2, m, dev)
    _check(b, "b", 2, m, dev)
    _check_gid(gid0, m)
    r = np.asarray(r, dtype=np.uint64).reshape(2)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no half-gates kernel for device {dev}")
    if m and dev.type == "cpu":
        return ref.garble_and(a, b, torch.from_numpy(r.view(np.int64).copy()),
                              gid0)
    c = torch.empty((m, 2), dtype=torch.int64, device=dev)
    tab = torch.empty((m, 4), dtype=torch.int64, device=dev)
    if m:   # an empty batch launches nothing
        kernel.launch_garble(a, b, int(r[0]), int(r[1]), gid0, c, tab)
        _count("garble", m)
    return c, tab


def eval_and(wa: torch.Tensor, wb: torch.Tensor, tab: torch.Tensor,
             gid0: int) -> torch.Tensor:
    """Evaluate m AND gates with ids gid0.. from the garbler's tables."""
    m = wa.shape[0] if isinstance(wa, torch.Tensor) and wa.dim() else -1
    dev = wa.device
    _check(wa, "wa", 2, m, dev)
    _check(wb, "wb", 2, m, dev)
    _check(tab, "tab", 4, m, dev)
    _check_gid(gid0, m)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no half-gates kernel for device {dev}")
    if m and dev.type == "cpu":
        return ref.eval_and(wa, wb, tab, gid0)
    c = torch.empty((m, 2), dtype=torch.int64, device=dev)
    if m:   # an empty batch launches nothing
        kernel.launch_eval(wa, wb, tab, gid0, c)
        _count("eval", m)
    return c
