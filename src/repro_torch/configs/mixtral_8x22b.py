"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attn [arXiv:2401.04088]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    layer_pattern=("local_moe",), window=4096,
    n_experts=8, top_k=2,
    sparse_autotune=True,
)
