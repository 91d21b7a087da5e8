"""Unified model configuration covering all assigned architecture families:
dense / MoE / SSM (Mamba2, xLSTM) / hybrid / encoder-decoder / VLM-audio
backbones.  One dataclass so that configs/<arch>.py stay declarative."""

from __future__ import annotations

import dataclasses
import enum


class BlockKind(str, enum.Enum):
    ATTN = "attn"              # self-attention + MLP block
    MAMBA2 = "mamba2"          # SSD block
    MLSTM = "mlstm"            # xLSTM matrix-memory block
    SLSTM = "slstm"            # xLSTM scalar-memory block
    SHARED_ATTN = "shared_attn"  # zamba2-style shared transformer block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False        # qwen2
    rope_theta: float = 10_000.0
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_group_size: int = 1024
    # --- SSM / recurrent ---
    ssm_state: int = 0            # Mamba2 state dim N
    ssm_head_dim: int = 64        # Mamba2 P
    ssm_expand: int = 2
    ssm_chunk: int = 128
    slstm_every: int = 0          # xLSTM: every k-th block is sLSTM
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0    # apply the shared attn block every k layers
    # --- enc-dec (seamless) ---
    encoder_layers: int = 0       # >0 -> encoder-decoder model
    # --- modality stub ---
    frontend: str = "none"        # none | audio_frames | vq_image (stub note)
    # --- training defaults ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- serving ---
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (quantized KV)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        """True if no quadratic-attention path exists (long_500k eligible
        without caveats)."""
        return self.family == "ssm" and self.slstm_every >= 0 and \
            self.shared_attn_every == 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode: SSM/hybrid/linear-recurrent."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count_estimate(self) -> int:
        """Rough parameter count (embeddings + blocks), for MODEL_FLOPS."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp = 3 * d * self.d_ff
        if self.moe:
            expert_mlp = 3 * d * self.d_ff
            mlp = (self.n_experts + self.n_shared_experts) * expert_mlp \
                + d * self.n_experts
        d_in = self.ssm_expand * d
        nh = max(d_in // self.ssm_head_dim, 1)
        mamba = d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d \
            + 2 * d_in
        lstm_m = 4 * d * d  # qkv + out (mLSTM approx)
        per_layer = {
            "dense": attn + mlp, "moe": attn + mlp, "vlm": attn + mlp,
            "audio": attn + mlp,
            "ssm": lstm_m + mlp if self.slstm_every else mamba + mlp,
            "hybrid": mamba,
        }[self.family]
        total += self.n_layers * per_layer
        if self.shared_attn_every:
            total += attn + mlp  # one shared block
        if self.is_encdec:
            total += self.encoder_layers * (attn + mlp) \
                + self.n_layers * (attn // 2)  # cross-attention
        return int(total)

    def active_param_estimate(self) -> int:
        """Active params per token (MoE: only routed top_k + shared)."""
        if not self.moe:
            return self.param_count_estimate()
        d = self.d_model
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        mlp_active = 3 * d * self.d_ff * (self.top_k + self.n_shared_experts)
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += self.n_layers * (attn + mlp_active + d * self.n_experts)
        return int(total)
