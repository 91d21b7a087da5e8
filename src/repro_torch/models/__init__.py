"""The dense decoder of the serving path: the port's copy of
``repro.models`` (config, layers, the ATTN block, the LM) for the dense
family without experts."""

from .config import BlockKind, ModelConfig
from .lm import LM, init_caches, init_lm, lm_decode, lm_prefill

__all__ = ["BlockKind", "LM", "ModelConfig", "init_caches", "init_lm",
           "lm_decode", "lm_prefill"]
