"""zamba2-1.2b [hybrid] — Mamba-2 backbone with a *shared* attention block
invoked every 6th layer [arXiv:2411.15242].  The shared block's parameters
are deliberately NOT stacked per repetition — one param set reused at every
occurrence, matching Zamba's weight sharing.  38 layers = 6 x (5 mamba +
1 mamba+shared-attn) + 2 remainder mamba."""
from .base import ModelConfig

CONFIG = ModelConfig(
    use_seq_sp=False,  # recurrent: time scan needs the full sequence locally
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    layer_pattern=("mamba",) * 5 + ("mamba_attn",),
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
)
