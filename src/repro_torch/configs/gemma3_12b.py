"""gemma3-12b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt scaled family].  Local layers: 1024-token sliding
window, rope theta 10k; global layers: full attention, rope theta 1M.
Huge vocab (262144) -> sparse embedding-gradient path qualifies (DESIGN §4)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab_size=262144,
    layer_pattern=("local",) * 5 + ("attn",),
    window=1024, rope_theta=1e4, rope_theta_global=1e6,
    attn_logit_softcap=0.0,
    sparse_autotune=True,
)
