"""Architecture registry: the port's copy of ``repro.configs``.

``--arch <id>`` resolves through :func:`get_config`; :func:`reduced_config`
returns the same family scaled down for CPU tests, exactly as the reference
does.  The modules are imported statically (the reference resolves them by
name at run time); the shape cells and :func:`all_cells` (every arch x its
applicable shapes, the dry run's sweep) are the reference's.
"""

from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig
from . import (chameleon_34b, deepseek_moe_16b, internlm2_20b, minicpm_2b,
               phi35_moe_42b, qwen2_1_5b, seamless_m4t_medium, stablelm_3b,
               xlstm_1_3b, zamba2_7b)

ARCH_MODULES = {
    "zamba2-7b": zamba2_7b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "minicpm-2b": minicpm_2b,
    "internlm2-20b": internlm2_20b,
    "stablelm-3b": stablelm_3b,
    "qwen2-1.5b": qwen2_1_5b,
    "chameleon-34b": chameleon_34b,
    "xlstm-1.3b": xlstm_1_3b,
    "seamless-m4t-medium": seamless_m4t_medium,
}

ARCHS = sorted(ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    return ARCH_MODULES[name].CONFIG


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    cfg = get_config(name)
    changes: dict = dict(
        n_layers=max(2, (cfg.shared_attn_every or cfg.slstm_every or 1) + 1),
        d_model=128, n_heads=4, d_ff=256 if cfg.d_ff else 0,
        vocab_size=512, head_dim=0,
    )
    changes["n_kv_heads"] = min(cfg.n_kv_heads, 2) if \
        cfg.n_kv_heads < cfg.n_heads else 4
    if cfg.moe:
        changes.update(n_experts=4, top_k=min(cfg.top_k, 2),
                       router_group_size=64)
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.slstm_every:
        changes.update(slstm_every=2, n_layers=4)
    if cfg.shared_attn_every:
        changes.update(shared_attn_every=2, n_layers=5)
    if cfg.encoder_layers:
        changes.update(encoder_layers=2, n_layers=2)
    return dataclasses.replace(cfg, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")   # skipped for pure full-attention archs
    return out


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for a in ARCHS:
        cfg = get_config(a)
        for s in applicable_shapes(cfg):
            cells.append((a, s))
    return cells
