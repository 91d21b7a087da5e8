"""Gradient compression for data-parallel all-reduce: int8 quantization with
stochastic rounding and error feedback (1-bit-Adam-family trick): the
port's copy of ``repro.distributed.compression``, over a
``torch.distributed`` process group.

The noise is a ``torch.Generator``'s uniform draw (the reference's is a
JAX key's); :func:`stochastic_round` takes it as an argument, so the
rounding itself can be held to the reference's formula on the same noise.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def stochastic_round(y: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """round(y + noise) clipped to [-127, 127], float32 (round half to
    even, as ``jnp.round``)."""
    return torch.clamp(torch.round(y + noise), -127, 127)


def _noise(shape, gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) - 0.5


def quantize_int8(x: torch.Tensor, gen: torch.Generator
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor scale, stochastic rounding.  Returns (q int8, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    y = xf / scale
    q = stochastic_round(y, _noise(y.shape, gen, y.device))
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, group, gen: torch.Generator,
                    residual: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """All-reduce sum over ``group`` with an int8 payload and error
    feedback.  Returns (summed f32, new residual).  The scale is
    max-reduced first so every rank quantizes on the same grid; the
    payload is summed as int32."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual
    amax = torch.clamp(xf.abs().max(), min=1e-12)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax / 127.0
    y = xf / scale
    q = stochastic_round(y, _noise(y.shape, gen, y.device))
    new_residual = xf - q * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale, new_residual
