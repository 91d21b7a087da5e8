"""seamless-m4t-medium [arXiv:2308.11596]: encoder-decoder backbone; audio
frontend STUB (input_specs() provides precomputed frame embeddings).
vocab padded 256206 -> 256256 for TP divisibility."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio", n_layers=12, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=256256,
    encoder_layers=12, frontend="audio_frames",
)
