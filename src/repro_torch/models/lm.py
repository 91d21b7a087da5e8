"""The causal LM of the dense family: init, prefill and decode
(``repro.models.lm``'s ``("scan", ATTN, n_layers)`` layout of dense models:
``init_lm``, ``init_caches``, ``lm_prefill``, ``lm_decode``).

The reference scans one stacked parameter tree over the layers; here
:class:`LM` holds a ``ModuleList`` of blocks and the layer loop is a
Python loop.  Weights are seeded on the target device (a
``torch.Generator`` there, drawn in a fixed order with the reference's init
scales); they are not the reference's numbers for the same seed, so tests
carry the reference's weights across (``interop.lm_params_from_jax``).

Decode takes either the contiguous caches of :func:`init_caches` /
:func:`lm_prefill` (a list with one ``(k, v)`` pair, each ``(n_layers,
batch, max_seq, kv_heads, head_dim)``, the layout of the reference's scan
group) or a ``serve.paged_kv.PagedKVCache`` holding every layer, whose
attention goes through the paged-attention kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import resolve_device
from ..serve.paged_kv import PagedKVCache
from .blocks import Block
from .config import ModelConfig
from .layers import Embed, RMSNorm, embed, rmsnorm, unembed


def check_supported(cfg: ModelConfig) -> None:
    """The port runs the dense family without experts and a bf16/f32 KV
    cache; everything else waits (ROADMAP.md)."""
    if cfg.family != "dense" or cfg.moe or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' with experts' if cfg.moe else ''} is not ported yet; only "
            f"dense models without experts run (ROADMAP.md, Queue 1)")
    if cfg.kv_cache_dtype != "bfloat16":
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r} is not ported yet; "
            f"the KV cache is kept in the model's dtype (ROADMAP.md)")


class LM(nn.Module):
    """Embeddings, ``n_layers`` :class:`Block` s and the final norm."""

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.embed = Embed(cfg, gen)
        self.blocks = nn.ModuleList(Block(cfg, gen)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: str | torch.device | None = None) -> LM:
    return LM(cfg, seed, device)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device: str | torch.device | None = None) -> list:
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    return [(torch.zeros(shape, dtype=dt, device=dev),
             torch.zeros(shape, dtype=dt, device=dev))]


def lm_prefill(params: LM, tokens: torch.Tensor, cfg: ModelConfig,
               max_seq: int):
    """Prefill a prompt; returns (last-token logits (b, 1, v) f32, caches
    padded to max_seq)."""
    x = embed(params.embed, tokens)
    ks, vs = [], []
    for blk in params.blocks:
        x, (k, v) = blk.prefill(x, max_seq)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.embed, x[:, -1:]), [(torch.stack(ks),
                                                torch.stack(vs))]


def lm_decode(params: LM, token: torch.Tensor, caches,
              cache_len: torch.Tensor | None, cfg: ModelConfig):
    """One decode step.  token (b, 1) ids; cache_len (b,) valid lengths of
    contiguous caches, which are updated in place.  A paged cache keeps its
    own lengths (pass cache_len=None) and takes the new token's K/V.
    Returns (logits (b, 1, v) f32, caches)."""
    x = embed(params.embed, token)
    if isinstance(caches, PagedKVCache):
        if cache_len is not None:
            raise ValueError("a paged cache keeps its own lengths; pass "
                             "cache_len=None")
        step = caches.append_step()
        for layer, blk in enumerate(params.blocks):
            x = blk.decode_paged(x, caches, layer, step)
    else:
        (k, v), = caches
        for layer, blk in enumerate(params.blocks):
            x, _ = blk.decode(x, (k[layer], v[layer]), cache_len)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.embed, x), caches
