"""qwen2-1.5b [arXiv:2407.10671]: GQA kv=2, QKV bias."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936, qkv_bias=True,
)
