"""stablelm-3b [hf:stabilityai/stablelm-2 family]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912, vocab_size=50304,
)
