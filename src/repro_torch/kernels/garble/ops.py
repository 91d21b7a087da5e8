"""The half-gates wrappers the protocol layer calls, with launch counters.

Labels are ``(m, 2)`` int64 tensors (bit views of the uint64 pairs) and
tables ``(m, 4)`` int64 laid out ``[TG | TE]``, the message of the NumPy
gates.  The garbler's global offset R comes as ``(lo, hi)``, two Python
ints in [0, 2^64) (:func:`offset` converts the NumPy pair once).  On a CUDA
tensor a wrapper launches its kernel on the current stream (no
synchronisation; the outputs are two views of one allocation); on a CPU
tensor it runs the plain version in ``ref.py``; on anything else it
raises.  The counters count kernel launches only, so a run can show that
its ANDs went through the kernels.  They are plain integers without a
lock: a GC job's engines (every worker of both parties) take turns on
the transport's baton, so one engine at a time counts.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernel, ref

garble_launches = 0
eval_launches = 0
garble_ands = 0          # AND gates garbled by the kernel
eval_ands = 0            # AND gates evaluated by the kernel
#: launches by gate count, per kind
launch_sizes: dict[str, dict[int, int]] = {"garble": {}, "eval": {}}
_garble_sizes, _eval_sizes = launch_sizes["garble"], launch_sizes["eval"]

_I64 = torch.int64
_GID_END = 1 << 62
_U64_END = 1 << 64


def reset_counts() -> None:
    global garble_launches, eval_launches, garble_ands, eval_ands
    garble_launches = eval_launches = garble_ands = eval_ands = 0
    _garble_sizes.clear()
    _eval_sizes.clear()


def counts() -> dict:
    return {"garble_launches": garble_launches,
            "eval_launches": eval_launches,
            "garble_ands": garble_ands, "eval_ands": eval_ands,
            "launch_sizes": {k: dict(v) for k, v in launch_sizes.items()}}


def offset(r) -> tuple[int, int]:
    """The garbler's R, a (2,) uint64 array, as the wrappers take it."""
    r = np.asarray(r, dtype=np.uint64).reshape(2)
    return int(r[0]), int(r[1])


def _check(t: torch.Tensor, name: str, cols: int, m: int,
           device: torch.device) -> int:
    """Raise unless ``t`` is a contiguous (m, cols) int64 tensor on
    ``device``, 16-byte aligned on a card; return its address."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype is not _I64 or t.shape != (m, cols):
        raise ValueError(f"{name} must be ({m}, {cols}) int64, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    ptr = t.data_ptr()
    if ptr & 15 and device.type == "cuda":
        raise ValueError(f"{name} must be 16-byte aligned")
    return ptr


def _batch(a, name: str) -> tuple[int, torch.device]:
    """(m, device) of the first label tensor, whose own checks follow."""
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(a)}")
    dev = a.device
    if dev.type != "cuda" and dev.type != "cpu":
        raise ValueError(f"no half-gates kernel for device {dev}")
    return (a.shape[0] if a.dim() else -1), dev


def _check_gid(gid0: int, m: int) -> None:
    if not (0 <= gid0 and gid0 + m < _GID_END):
        raise ValueError(f"gate ids [{gid0}, {gid0 + m}) out of range")


def _garble_outputs(m: int, like: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """c (m, 2) and the table (m, 4) like ``like`` (int64, its device): two
    contiguous views of one allocation, the table 16 * m bytes in, so
    16-byte aligned as the kernel stores it.  (``as_strided`` is the
    cheapest view to make from Python.)"""
    out = like.new_empty(6 * m)
    return (out.as_strided((m, 2), (2, 1)),
            out.as_strided((m, 4), (4, 1), 2 * m))


def garble_and(a: torch.Tensor, b: torch.Tensor, r: tuple[int, int],
               gid0: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Garble m AND gates with ids gid0.. under the global offset ``r`` =
    (lo, hi), the garbler's R.  Returns (c0 (m, 2), tab (m, 4))."""
    global garble_launches, garble_ands
    m, dev = _batch(a, "a")
    pa = _check(a, "a", 2, m, dev)
    pb = _check(b, "b", 2, m, dev)
    _check_gid(gid0, m)
    r_lo, r_hi = r
    if type(r_lo) is not int or type(r_hi) is not int:
        raise TypeError(f"R must be two ints (see offset()), got {r!r}")
    if not (0 <= r_lo < _U64_END and 0 <= r_hi < _U64_END):
        raise ValueError(f"R = {r} is not two uint64 words")
    if m and dev.type == "cpu":
        rt = torch.tensor(np.array([r_lo, r_hi], np.uint64).view(np.int64))
        return ref.garble_and(a, b, rt, gid0)
    c, tab = _garble_outputs(m, a)
    if m:   # an empty batch launches nothing
        kernel.launch_garble(pa, pb, r_lo, r_hi, gid0, c.data_ptr(),
                             tab.data_ptr(), m, a.get_device())
        garble_launches += 1
        garble_ands += m
        _garble_sizes[m] = _garble_sizes.get(m, 0) + 1
    return c, tab


def eval_and(wa: torch.Tensor, wb: torch.Tensor, tab: torch.Tensor,
             gid0: int) -> torch.Tensor:
    """Evaluate m AND gates with ids gid0.. from the garbler's tables."""
    global eval_launches, eval_ands
    m, dev = _batch(wa, "wa")
    pa = _check(wa, "wa", 2, m, dev)
    pb = _check(wb, "wb", 2, m, dev)
    pt = _check(tab, "tab", 4, m, dev)
    _check_gid(gid0, m)
    if m and dev.type == "cpu":
        return ref.eval_and(wa, wb, tab, gid0)
    c = wa.new_empty((m, 2))
    if m:   # an empty batch launches nothing
        kernel.launch_eval(pa, pb, pt, gid0, c.data_ptr(), m,
                           wa.get_device())
        eval_launches += 1
        eval_ands += m
        _eval_sizes[m] = _eval_sizes.get(m, 0) + 1
    return c
