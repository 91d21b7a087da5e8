"""xlstm-1.3b [arXiv:2405.04517]: mLSTM/sLSTM mix (7:1), attention-free ->
long_500k eligible.  d_ff=0: xLSTM blocks carry their own projections."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304, slstm_every=8,
)
