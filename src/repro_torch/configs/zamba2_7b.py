"""zamba2-7b [arXiv:2411.15242]: Mamba2 backbone + shared attention blocks.

81 Mamba2 layers with ONE shared attention+MLP block applied every 6 layers
(weight sharing — each application has its own KV cache).  hybrid family ->
long_500k eligible.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, shared_attn_every=6,
)
