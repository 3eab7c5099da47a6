"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].  The EnCodec frontend is a stub per spec: input_specs()
supplies precomputed conditioning frame embeddings (frontend_len tokens)
prepended to the codec-token sequence; vocab=2048 is the codebook size."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    layer_pattern=("attn",),
    frontend="audio", frontend_len=64,
)
