"""Model/config system: one frozen dataclass describes any architecture in
the zoo; per-arch files in this package instantiate it.

A copy of the JAX package's ``configs/base.py`` (the same fields, defaults
and derived properties), except that :attr:`ModelConfig.compute_dtype` is a
``torch.dtype``.  Notes on TPU meshes and scans describe the reference; the
port runs one card and loops over layers.

``layer_pattern`` is the *period* of block kinds that repeats through the
depth (lax.scan over repetitions keeps the HLO O(period) — DESIGN.md §7).
Remainder layers (n_layers % period) are applied unrolled with their own
(unstacked) parameters.

Block kinds:
  attn        — global attention + MLP
  local       — sliding-window attention + MLP
  moe         — attention + mixture-of-experts FFN
  local_moe   — SWA attention + MoE FFN (mixtral)
  mamba       — Mamba-2 (SSD) block
  mamba_attn  — Mamba-2 block followed by the *shared* attention block
                (zamba2: one attention param set reused at every occurrence)
  mlstm       — xLSTM mLSTM block (matrix memory, parallel/chunk form)
  slstm       — xLSTM sLSTM block (scalar memory, true recurrence)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

ATTN_KINDS = ("attn", "local", "moe", "local_moe")
SSM_KINDS = ("mamba", "mamba_attn")
XLSTM_KINDS = ("mlstm", "slstm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[str, ...] = ("attn",)
    d_head: Optional[int] = None    # default d_model // n_heads
    # attention
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None   # gemma3 global layers
    window: int = 4096              # SWA window for "local*" kinds
    attn_logit_softcap: float = 0.0
    flash_kv_chunk: int = 1024      # flash-attention KV block (§Perf knob)
    swa_banded: bool = False        # banded SWA flash (§Perf: exact and a
                                    # 6.4x FLOP cut single-device, but the
                                    # dynamic_slice over seq-sharded KV
                                    # breaks GSPMD propagation — measured
                                    # 2x WORSE per-device compute on the
                                    # 16x16 mesh; off by default)
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "ell"       # "ell" | "csr" | "auto" (paper AT rule)
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # xlstm
    mlstm_expand: int = 2
    # frontends (vlm/audio stubs — precomputed embeddings via input_specs)
    frontend: Optional[str] = None  # "vit" | "audio"
    frontend_len: int = 0
    # misc
    use_seq_sp: bool = True         # sequence-parallel residual stream.
                                    # §Perf: WRONG for recurrent archs —
                                    # the time scan needs the full sequence
                                    # locally, so seq-SP forces a gather +
                                    # re-scatter of q/k/v/gates per layer
    kv_quant: bool = False          # int8 KV cache (serving)
    embed_tp_lookup: bool = False   # §Perf: shard embed table over model on
                                    # d (local gather) instead of vocab
                                    # (kills the GSPMD full-table remat)
    xlstm_shard_recurrent: bool = True  # §Perf: False = replicate small
                                        # recurrent weights (no per-step AR)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: str = "full"             # none | dots | full (full = recompute; only scan-rep carries saved)
    sparse_autotune: bool = False   # paper-technique integrations enabled
    # sharding-driven head padding (resolved; see resolve_for_tp)
    pad_heads_to: Optional[int] = None
    pad_kv_heads_to: Optional[int] = None

    # ---- derived ----------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def eff_heads(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def eff_kv_heads(self) -> int:
        return self.pad_kv_heads_to or self.n_kv_heads

    @property
    def q_per_kv(self) -> int:
        assert self.eff_heads % self.eff_kv_heads == 0, \
            (self.eff_heads, self.eff_kv_heads)
        return self.eff_heads // self.eff_kv_heads

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def scan_reps(self) -> int:
        return self.n_layers // self.period

    @property
    def remainder_pattern(self) -> Tuple[str, ...]:
        return self.layer_pattern[: self.n_layers % self.period]

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def is_recurrent(self) -> bool:
        """True if decode state is O(1) in context length (SSM/xLSTM)."""
        return all(k in SSM_KINDS + XLSTM_KINDS for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: recurrent, or attention is windowed except
        a bounded number of global layers (DESIGN.md §5)."""
        if self.is_recurrent:
            return True
        kinds = set(self.layer_pattern)
        return bool(kinds & {"local", "local_moe", "mamba", "mamba_attn",
                             "mlstm", "slstm"})

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- TP head padding (exact-preserving; DESIGN.md §6) ------------------
    def resolve_for_tp(self, tp: int) -> "ModelConfig":
        """Pad head counts so they divide the tensor-parallel degree.

        * GQA kv padding replicates each kv head r times (exactness: a
          replicated kv head splits its query group — identical math);
        * MHA q/kv padding adds zero-projection heads (o-proj columns zero —
          identical math).  Only shapes matter for lowering; the exactness
          argument documents why the padded model is the same function."""
        if not any(k in ATTN_KINDS for k in self.layer_pattern + ("attn",)):
            return self
        kv, h = self.n_kv_heads, self.n_heads
        if kv % tp == 0 and h % tp == 0:
            return self
        kv_p = kv if kv % tp == 0 else ((kv + tp - 1) // tp) * tp
        if kv_p % kv == 0 or kv == h:
            # GQA replication (integer factor) or MHA zero-padding
            h_p = ((h + kv_p - 1) // kv_p) * kv_p if kv == h else h
            h_p = h_p if h_p % tp == 0 else ((h_p + tp - 1) // tp) * tp
            if h_p % kv_p != 0:
                h_p = ((h_p + kv_p - 1) // kv_p) * kv_p
            return self.replace(pad_heads_to=h_p, pad_kv_heads_to=kv_p)
        return self.replace(pad_kv_heads_to=kv_p,
                            pad_heads_to=((h + kv_p - 1) // kv_p) * kv_p)


# ---------------------------------------------------------------------------
# input shapes (assigned cells)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: tiny widths/depths,
    few experts, small vocab — one full period of the layer pattern."""
    n_layers = max(len(cfg.layer_pattern), 2)
    if cfg.n_layers % len(cfg.layer_pattern):
        n_layers += cfg.n_layers % len(cfg.layer_pattern) and 1
    return cfg.replace(
        n_layers=len(cfg.layer_pattern) * 2 + len(cfg.remainder_pattern),
        d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_head=16, d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4), top_k=min(cfg.top_k, 2),
        ssm_state=16 if cfg.ssm_state else 0,
        window=32, frontend_len=8 if cfg.frontend else 0,
        dtype="float32", remat="none",
        pad_heads_to=None, pad_kv_heads_to=None,
    )


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "smoke_config",
           "ATTN_KINDS", "SSM_KINDS", "XLSTM_KINDS"]
