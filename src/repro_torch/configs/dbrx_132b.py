"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

MoE dispatch is the paper-technique integration point: the token->expert
dispatch matrix is ELL (fixed capacity, padded) vs CSR (dropless); the
D_mat = sigma/mu of tokens-per-expert drives the run-time choice."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    layer_pattern=("moe",),
    n_experts=16, top_k=4,
    sparse_autotune=True,
)
