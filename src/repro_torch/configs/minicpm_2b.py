"""minicpm-2b [arXiv:2404.06395]: llama-like dense; WSD schedule is wired in
train/optimizer.py.  vocab padded 122753 -> 122880 (multiple of 256) for TP
divisibility (Megatron-style padding)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
    n_heads=36, n_kv_heads=36, d_ff=5760, vocab_size=122880,
    tie_embeddings=True,
)
