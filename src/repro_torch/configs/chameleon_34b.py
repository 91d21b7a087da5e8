"""chameleon-34b [arXiv:2405.09818]: early-fusion VLM — VQ image tokens are
ordinary vocab entries, so the backbone is a dense decoder; the image
tokenizer frontend is a STUB (input_specs() supplies token ids that may
fall in the image-token vocab range)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab_size=65536,
    frontend="vq_image",
)
