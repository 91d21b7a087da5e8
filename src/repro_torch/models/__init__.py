"""The models: the port's copy of ``repro.models`` (config, layers, the
blocks of every kind, the causal LM of every decoder-only family and the
encoder-decoder, each with its training forward and loss)."""

from .config import BlockKind, ModelConfig
from .encdec import (EncDec, encdec_decode, encdec_forward,
                     encdec_init_caches, encdec_loss, encdec_prefill, encode,
                     init_encdec)
from .lm import (LM, PagedCaches, grouped_layout, init_caches, init_lm,
                 lm_decode, lm_forward, lm_loss, lm_prefill)

__all__ = ["BlockKind", "EncDec", "LM", "ModelConfig", "PagedCaches",
           "encdec_decode", "encdec_forward", "encdec_init_caches",
           "encdec_loss", "encdec_prefill", "encode", "grouped_layout",
           "init_caches", "init_encdec", "init_lm", "lm_decode",
           "lm_forward", "lm_loss", "lm_prefill"]
