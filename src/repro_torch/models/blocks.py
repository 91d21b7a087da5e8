"""Block assembly and the layer layout: one residual block per layer kind
(the port's copy of ``repro.models.blocks``: ``init_block``,
``block_train``, ``block_init_cache``, ``block_prefill``, ``block_decode``,
``layout``).

Layouts:
  dense/moe/vlm/audio : [ATTN x n_layers]
  ssm (xLSTM)         : [(MLSTM x (k-1), SLSTM) x n_rep]
  hybrid (zamba2)     : [(MAMBA2 x k, SHARED_ATTN) x n_rep, MAMBA2 x tail]
                        SHARED_ATTN reuses ONE parameter set at every
                        application, and each application has its own KV
                        cache.

The recurrent kinds prefill with their parallel form and rebuild the state
decode starts from with the reference's sequential replay: one decode call
a prompt token, which is exact and costs a decode step a token.  Training
(``Block.forward``, the reference's ``block_train``; a method named
``train`` would shadow ``nn.Module.train``, which ``eval()`` calls) runs
the parallel forms only.
"""

from __future__ import annotations

import torch
from torch import nn

from ..distributed.sharding import pad
from .config import BlockKind, ModelConfig
from .layers import (MLP, Attention, RMSNorm, _dtype, _quantize_kv,
                     attention, attention_decode, attention_decode_paged,
                     attention_prefill, mlp, rmsnorm)
from .mamba2 import Mamba2, mamba2_block, mamba2_decode, mamba2_init_state
from .moe import MoE, moe_mlp
from .xlstm import (MLSTM, SLSTM, mlstm_block, mlstm_decode,
                    mlstm_init_state, slstm_block, slstm_decode,
                    slstm_init_state)

ATTN_KINDS = (BlockKind.ATTN, BlockKind.SHARED_ATTN)


class Block(nn.Module):
    """``init_block`` of one kind.  ATTN and SHARED_ATTN: pre-norm
    self-attention, then a SwiGLU MLP, or the MoE MLP for an ATTN block of
    a model with experts; MAMBA2, MLSTM and SLSTM: pre-norm mixer."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 kind: BlockKind = BlockKind.ATTN):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.ln1 = RMSNorm(cfg.d_model, gen.device)
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, gen)
            self.ln2 = RMSNorm(cfg.d_model, gen.device)
            if cfg.moe and kind == BlockKind.ATTN:
                self.moe = MoE(cfg, gen)
            else:
                self.mlp = MLP(cfg, gen)
        elif kind == BlockKind.MAMBA2:
            self.mamba = Mamba2(cfg, gen)
        elif kind == BlockKind.MLSTM:
            self.mlstm = MLSTM(cfg, gen)
        elif kind == BlockKind.SLSTM:
            self.slstm = SLSTM(cfg, gen)
        else:
            raise ValueError(kind)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(self.ln2, x, self.cfg.norm_eps)
        if hasattr(self, "moe"):
            return x + moe_mlp(self.moe, h, self.cfg)[0]
        return x + mlp(self.mlp, h)

    def _mixer(self):
        """(module, block fn, decode fn, init-state fn) of a recurrent
        kind."""
        if self.kind == BlockKind.MAMBA2:
            return self.mamba, mamba2_block, mamba2_decode, mamba2_init_state
        if self.kind == BlockKind.MLSTM:
            return self.mlstm, mlstm_block, mlstm_decode, mlstm_init_state
        return self.slstm, slstm_block, slstm_decode, slstm_init_state

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward (``block_train``): returns (x, aux loss),
        the aux loss the MoE's load-balancing term (0 for every other
        block).  The recurrent kinds run their parallel forms."""
        if self.kind in ATTN_KINDS:
            return self.mlp_half(self.attn_half(x))
        cfg = self.cfg
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        mod, block, _, _ = self._mixer()
        return x + block(mod, h, cfg), aux

    def attn_half(self, x: torch.Tensor) -> torch.Tensor:
        """An attention kind's first half: x + attention, the
        post-attention residual (the reference's first ``block_out``)."""
        cfg = self.cfg
        return x + attention(self.attn, rmsnorm(self.ln1, x, cfg.norm_eps),
                             cfg)

    def mlp_half(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """An attention kind's second half: (x + the MLP's or the MoE's
        output, aux loss)."""
        cfg = self.cfg
        if hasattr(self, "moe"):
            out, aux = moe_mlp(self.moe, rmsnorm(self.ln2, x, cfg.norm_eps),
                               cfg)
            return x + out, aux
        return self._mlp(x), torch.zeros((), dtype=torch.float32,
                                         device=x.device)

    def prefill(self, x: torch.Tensor, max_seq: int):
        """Returns (x, cache): for the attention kinds (k, v), or the int8
        (k_q, v_q, k_scale, v_scale), padded to max_seq positions; for the
        recurrent kinds the state after the prompt."""
        cfg = self.cfg
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        if self.kind in ATTN_KINDS:
            out, (k, v) = attention_prefill(self.attn, h, cfg)
            x = self._mlp(x + out)
            n_pad = max_seq - k.shape[1]
            if cfg.kv_cache_dtype == "int8":
                (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
                p4, p3 = (0, 0, 0, 0, 0, n_pad), (0, 0, 0, n_pad)
                return x, (pad(kq, p4), pad(vq, p4), pad(ks, p3),
                           pad(vs, p3))
            p4, dt = (0, 0, 0, 0, 0, n_pad), _dtype(cfg)
            return x, (pad(k.to(dt), p4), pad(v.to(dt), p4))
        mod, block, decode, init_state = self._mixer()
        y = block(mod, h, cfg)
        state = init_state(cfg, x.shape[0], x.device)
        for t in range(h.shape[1]):           # the sequential replay
            state = decode(mod, h[:, t:t + 1], cfg, state)[1]
        return x + y, state

    def decode(self, x: torch.Tensor, cache, cache_len: torch.Tensor):
        """One token; returns (x, cache).  An attention cache is written in
        place; a recurrent kind returns its new state."""
        cfg = self.cfg
        h = rmsnorm(self.ln1, x, cfg.norm_eps)
        if self.kind in ATTN_KINDS:
            out, cache = attention_decode(self.attn, h, cfg, cache,
                                          cache_len)
            return self._mlp(x + out), cache
        mod, _, decode, _ = self._mixer()
        y, state = decode(mod, h, cfg, cache)
        return x + y, state

    def decode_paged(self, x: torch.Tensor, cache, layer: int,
                     step) -> torch.Tensor:
        """One token of an attention kind against layer ``layer`` of a
        paged cache."""
        cfg = self.cfg
        out = attention_decode_paged(
            self.attn, rmsnorm(self.ln1, x, cfg.norm_eps), cfg, cache,
            layer, step)
        return self._mlp(x + out)


def block_init_cache(cfg: ModelConfig, kind: BlockKind, batch: int,
                     max_seq: int, device):
    dt = _dtype(cfg)
    if kind in ATTN_KINDS:
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_cache_dtype == "int8":
            sshape = shape[:3]
            return tuple(torch.zeros(s, dtype=t, device=device) for s, t in
                         ((shape, torch.int8), (shape, torch.int8),
                          (sshape, torch.float16), (sshape, torch.float16)))
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))
    if kind == BlockKind.MAMBA2:
        return mamba2_init_state(cfg, batch, device)
    if kind == BlockKind.MLSTM:
        return mlstm_init_state(cfg, batch, device)
    if kind == BlockKind.SLSTM:
        return slstm_init_state(cfg, batch, device)
    raise ValueError(kind)


def layout(cfg: ModelConfig) -> list[tuple[BlockKind, int]]:
    """Flat (kind, count) segment list describing the layer stack."""
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return [(BlockKind.ATTN, cfg.n_layers)]
    if cfg.family == "ssm":
        k = cfg.slstm_every
        if not k:
            return [(BlockKind.MLSTM, cfg.n_layers)]
        n_rep = cfg.n_layers // k
        segs = [(BlockKind.MLSTM, k - 1), (BlockKind.SLSTM, 1)] * n_rep
        tail = cfg.n_layers - n_rep * k
        return segs + ([(BlockKind.MLSTM, tail)] if tail else [])
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        n_rep = cfg.n_layers // k
        segs = [(BlockKind.MAMBA2, k), (BlockKind.SHARED_ATTN, 1)] * n_rep
        tail = cfg.n_layers - n_rep * k
        return segs + ([(BlockKind.MAMBA2, tail)] if tail else [])
    raise ValueError(cfg.family)
