"""The residual block of the dense decoder: the ATTN branches of
``repro.models.blocks`` (``init_block``, ``block_init_cache``,
``block_prefill``, ``block_decode``).  Other block kinds are not ported
(ROADMAP.md)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import (MLP, Attention, RMSNorm, attention_decode,
                     attention_decode_paged, attention_prefill, mlp, rmsnorm)


class Block(nn.Module):
    """Pre-norm self-attention + SwiGLU MLP (``BlockKind.ATTN``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, gen.device)
        self.attn = Attention(cfg, gen)
        self.ln2 = RMSNorm(cfg.d_model, gen.device)
        self.mlp = MLP(cfg, gen)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return x + mlp(self.mlp, rmsnorm(self.ln2, x, self.cfg.norm_eps))

    def prefill(self, x: torch.Tensor, max_seq: int):
        """Returns (x, (k, v)), the cache padded to max_seq positions."""
        cfg = self.cfg
        out, (k, v) = attention_prefill(
            self.attn, rmsnorm(self.ln1, x, cfg.norm_eps), cfg)
        pad = (0, 0, 0, 0, 0, max_seq - k.shape[1])
        dt = getattr(torch, cfg.dtype)
        return self._mlp(x + out), (F.pad(k.to(dt), pad),
                                    F.pad(v.to(dt), pad))

    def decode(self, x: torch.Tensor, cache, cache_len: torch.Tensor):
        """One token against a contiguous cache; returns (x, cache)."""
        cfg = self.cfg
        out, cache = attention_decode(
            self.attn, rmsnorm(self.ln1, x, cfg.norm_eps), cfg, cache,
            cache_len)
        return self._mlp(x + out), cache

    def decode_paged(self, x: torch.Tensor, cache, layer: int,
                     step) -> torch.Tensor:
        """One token against layer ``layer`` of a paged cache."""
        cfg = self.cfg
        out = attention_decode_paged(
            self.attn, rmsnorm(self.ln1, x, cfg.norm_eps), cfg, cache,
            layer, step)
        return self._mlp(x + out)
