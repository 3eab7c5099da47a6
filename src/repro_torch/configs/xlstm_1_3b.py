"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, 7:1 ratio [arXiv:2405.04517].

d_ff=0: xLSTM blocks carry their own up/down projections (no separate FFN).
48 layers = 6 repetitions of (7 mLSTM + 1 sLSTM)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    use_seq_sp=False,  # recurrent: time scan needs the full sequence locally
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    layer_pattern=("mlstm",) * 7 + ("slstm",),
    mlstm_expand=2,
)
