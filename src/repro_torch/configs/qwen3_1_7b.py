"""qwen3-1.7b [dense] — GQA with per-head q/k RMS norm [hf:Qwen/Qwen3-8B family]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab_size=151936,
    layer_pattern=("attn",),
    qk_norm=True, rope_theta=1e6,
)
