"""deepseek-moe-16b [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64
routed experts, top-6."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=102400,
    moe=True, n_experts=64, n_shared_experts=2, top_k=6,
)
