"""minitron-8b [dense] — width/depth-pruned Nemotron-4 [arXiv:2407.14679].
256k vocab -> sparse embedding-gradient path qualifies (DESIGN §4)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    layer_pattern=("attn",),
    sparse_autotune=True,
)
