"""Encoder-decoder model (the seamless-m4t backbone): the port's copy of
``repro.models.encdec``'s ``init_encdec``, ``encode``, ``_dec_block``,
``encdec_forward``, ``encdec_loss``, ``encdec_prefill``,
``encdec_init_caches`` and ``encdec_decode``.

The audio frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings (batch, frames, d_model); the decoder is a
causal transformer with cross-attention into the encoder memory.  A decode
step recomputes the memory's K/V (``attention_cross``) at every layer, as
the reference does; its self-attention cache is ``(k, v)``, each
(n_layers, batch, max_seq, kv_heads, head_dim), updated in place.
Training is teacher-forced cross entropy, every encoder and decoder layer
checkpointed under ``remat``.

The frames enter in the model's dtype.  The reference promotes its bf16
encoder to float32 when handed float32 frames (the data pipeline's); the
port casts the frames instead, so a bf16 model's encoder runs in bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import resolve_device
from .config import ModelConfig
from .layers import (MLP, Attention, Embed, RMSNorm, _dtype, attention,
                     attention_cross, attention_decode, embed, mlp,
                     remat_call, rmsnorm, unembed)
from .lm import next_token_nll


class EncLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, gen.device)
        self.attn = Attention(cfg, gen)
        self.ln2 = RMSNorm(cfg.d_model, gen.device)
        self.mlp = MLP(cfg, gen)


class DecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, gen.device)
        self.attn = Attention(cfg, gen)
        self.lnx = RMSNorm(cfg.d_model, gen.device)
        self.xattn = Attention(cfg, gen)
        self.ln2 = RMSNorm(cfg.d_model, gen.device)
        self.mlp = MLP(cfg, gen)


class EncDec(nn.Module):
    """``init_encdec``: ``encoder_layers`` encoder layers, ``n_layers``
    decoder layers, the embeddings and the two final norms."""

    #: the parameters the reference stacks over a leading layer axis
    stacked_prefixes = ("enc.", "dec.")

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} has no encoder (encoder_layers=0)")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.embed = Embed(cfg, gen)
        self.enc = nn.ModuleList(EncLayer(cfg, gen)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(DecLayer(cfg, gen)
                                 for _ in range(cfg.n_layers))
        self.enc_norm = RMSNorm(cfg.d_model, dev)
        self.final_norm = RMSNorm(cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


def init_encdec(cfg: ModelConfig, seed: int = 0,
                device: str | torch.device | None = None) -> EncDec:
    return EncDec(cfg, seed, device)


def _enc_block(p: EncLayer, h: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    h = h + attention(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), cfg,
                      causal=False)
    return h + mlp(p.mlp, rmsnorm(p.ln2, h, cfg.norm_eps))


def encode(params: EncDec, frames: torch.Tensor, cfg: ModelConfig,
           remat: bool = True) -> torch.Tensor:
    """frames: (b, s, d) precomputed frame embeddings (the frontend
    stub) -> the encoder memory (b, s, d).  ``remat`` checkpoints each
    layer when autograd records."""
    h = frames.to(_dtype(cfg))
    for p in params.enc:
        h = remat_call(_enc_block, p, h, cfg, remat=remat)
    return rmsnorm(params.enc_norm, h, cfg.norm_eps)


def _dec_block(p: DecLayer, h: torch.Tensor, memory: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    h = h + attention(p.attn, rmsnorm(p.ln1, h, cfg.norm_eps), cfg)
    h = h + attention_cross(p.xattn, rmsnorm(p.lnx, h, cfg.norm_eps),
                            memory, cfg)
    return h + mlp(p.mlp, rmsnorm(p.ln2, h, cfg.norm_eps))


def encdec_forward(params: EncDec, frames: torch.Tensor,
                   tokens: torch.Tensor, cfg: ModelConfig,
                   remat: bool = True) -> torch.Tensor:
    """Teacher-forced logits (b, s, v) f32 of the decoder over tokens (b, s)
    against the encoder memory of frames."""
    memory = encode(params, frames, cfg, remat)
    x = embed(params.embed, tokens)
    for p in params.dec:
        x = remat_call(_dec_block, p, x, memory, cfg, remat=remat)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.embed, x)


def encdec_loss(params: EncDec, frames: torch.Tensor, tokens: torch.Tensor,
                cfg: ModelConfig, remat: bool = True
                ) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy: (loss, {"loss"})."""
    logits = encdec_forward(params, frames, tokens[:, :-1], cfg, remat)
    loss = next_token_nll(logits, tokens[:, 1:])
    return loss, {"loss": loss}


def encdec_prefill(params: EncDec, frames: torch.Tensor,
                   tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Prompt processing for serving: the logits of the last position only
    (b, 1, v) f32.  Like the reference it returns no cache: a decode
    starts from :func:`encdec_init_caches` and feeds the prompt."""
    memory = encode(params, frames, cfg, remat=False)
    x = embed(params.embed, tokens)
    for p in params.dec:
        x = _dec_block(p, x, memory, cfg)
    x = rmsnorm(params.final_norm, x[:, -1:], cfg.norm_eps)
    return unembed(params.embed, x)


def encdec_init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                       device: str | torch.device | None = None) -> tuple:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            torch.zeros(shape, dtype=_dtype(cfg), device=dev))


def encdec_decode(params: EncDec, token: torch.Tensor, memory: torch.Tensor,
                  caches: tuple, cache_len: torch.Tensor, cfg: ModelConfig):
    """One decoder step against the encoder memory and the self-attention
    cache.  Returns (logits (b, 1, v) f32, caches)."""
    x = embed(params.embed, token)
    k, v = caches
    for i, p in enumerate(params.dec):
        out, _ = attention_decode(p.attn, rmsnorm(p.ln1, x, cfg.norm_eps),
                                  cfg, (k[i], v[i]), cache_len)
        x = x + out
        x = x + attention_cross(p.xattn, rmsnorm(p.lnx, x, cfg.norm_eps),
                                memory, cfg)
        x = x + mlp(p.mlp, rmsnorm(p.ln2, x, cfg.norm_eps))
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.embed, x), caches
