"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

The ViT frontend is a stub per spec: input_specs() supplies precomputed
patch embeddings (frontend_len tokens) prepended to the text sequence."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    layer_pattern=("attn",),
    frontend="vit", frontend_len=256,
)
