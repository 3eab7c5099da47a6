"""Closed-form (trip-count-aware) roofline terms per (arch x shape) cell.

A copy of the JAX package's ``launch/analytic.py``: the same FLOP, byte and
collective counts for the same configs.  The reference records these
beside XLA's ``compiled.cost_analysis()``, which counts every while-loop
body once; the port records them beside its dry run's trace of the step
(``launch/dryrun.py:analyze_cell``; ``launch/roofline.py``), and the
``train`` phase of ``chip_smoke.py`` states a training step's bound from
them.

Conventions:
  * FLOPs: 2*M*N*K per matmul; train = 3x forward (fwd + 2x bwd) + 1x fwd
    remat recompute (remat="full") = 4x fwd.
  * Bytes (per device, per step): parameter reads (bf16 compute copies) +
    gradient/optimizer RW (train) + KV-cache/state RW (decode) + activation
    streams (2 reads + 1 write of the residual stream per block matmul
    chain, bf16).
  * Collectives (per device, per step): FSDP param all-gather (fwd + bwd
    recompute + bwd = 3x per microbatch, bf16) + gradient reduce-scatter
    (f32) + TP activation all-reduces (2 per block) + MoE all-to-all
    (dispatch+combine buffers) + SP/CP gathers for sequence-sharded
    attention (``launch/dryrun.py`` divides them by the slowest link the
    mesh spans; one card moves none of them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import n_active_params, n_params


@dataclass
class AnalyticCosts:
    flops: float              # per device
    bytes: float              # per device (HBM)
    collective_bytes: float   # per device (ICI)
    detail: Dict[str, float]


def _attn_flops_fwd(cfg: ModelConfig, B: int, S: int, S_kv: int) -> float:
    d, H, KV, Dh = cfg.d_model, cfg.eff_heads, cfg.eff_kv_heads, cfg.head_dim
    proj = 2 * B * S * d * (H + 2 * KV + H) * Dh        # q,k,v,o
    scores = 2 * B * S * S_kv * H * Dh * 2              # qk^T + pv
    return proj + scores


def _block_flops_fwd(kind: str, cfg: ModelConfig, B: int, S: int,
                     S_kv: int) -> float:
    d, ff = cfg.d_model, cfg.d_ff
    if kind in ("attn", "local", "moe", "local_moe"):
        win = min(cfg.window, S_kv) if kind in ("local", "local_moe") \
            else S_kv
        f = _attn_flops_fwd(cfg, B, S, win)
        if kind in ("moe", "local_moe"):
            # router + top_k expert SwiGLU with capacity padding
            f += 2 * B * S * d * cfg.n_experts
            f += (2 * B * S * d * ff * 3 * cfg.top_k *
                  cfg.capacity_factor)
        else:
            f += 2 * B * S * d * ff * 3
        return f
    if kind in ("mamba", "mamba_attn"):
        d_in = cfg.ssm_expand * d
        N = cfg.ssm_state
        H = d_in // cfg.ssm_head_dim
        hd = cfg.ssm_head_dim
        L = min(256, S)
        f = 2 * B * S * d * (2 * d_in + 2 * N + H)          # in_proj
        f += 2 * B * S * d_in * d                           # out_proj
        f += 2 * B * S * (cfg.ssm_conv * (d_in + 2 * N))    # conv
        f += 2 * B * S * L * N                              # intra CB^T
        f += 2 * B * S * L * H * hd                         # intra M@x
        f += 4 * B * S * N * H * hd                         # state upd+read
        if kind == "mamba_attn":
            f += _attn_flops_fwd(cfg, B, S, S_kv)
            f += 2 * B * S * d * ff * 3
        return f
    if kind == "mlstm":
        d_in = cfg.mlstm_expand * d
        H = cfg.n_heads
        dv = d_in // H
        dk = max(dv // 2, 8)
        f = 2 * B * S * d * (2 * d_in + 2 * H * dk + 2 * H)  # projections
        f += 2 * B * S * d_in * d                            # out_proj
        f += 2 * B * S * H * dk * dv * 3                     # C upd + read
        return f
    if kind == "slstm":
        H = cfg.n_heads
        dh = d // H
        f = 2 * B * S * d * 4 * d                            # in_proj
        f += 2 * B * S * H * dh * 4 * dh                     # recurrent R
        f += 2 * B * S * d * d                               # out_proj
        return f
    raise KeyError(kind)


def _layer_list(cfg: ModelConfig):
    return (list(cfg.layer_pattern) * cfg.scan_reps +
            list(cfg.remainder_pattern))


def analytic_costs(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                   data_shards: int, model_shards: int) -> AnalyticCosts:
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    S_q = 1 if decode else S
    S_kv = S
    layers = _layer_list(cfg)
    d = cfg.d_model

    fwd = sum(_block_flops_fwd(k, cfg, B, S_q, S_kv) for k in layers)
    fwd += 2 * B * S_q * d * cfg.vocab_size            # lm head
    mult = 4.0 if shape.kind == "train" else 1.0       # bwd + remat
    flops_total = fwd * mult
    flops_dev = flops_total / chips

    # ---- bytes ---------------------------------------------------------
    Np = n_params(cfg)
    param_bytes_dev = 2 * Np / chips                   # bf16 compute copy
    micro = 1
    if shape.kind == "train":
        from .steps import default_microbatches
        micro = default_microbatches(cfg, shape)
    tokens_dev = B * S_q / data_shards
    act_stream = 6 * tokens_dev * d * 2 * len(layers)  # resid r/w, bf16
    byts = param_bytes_dev * (3 if shape.kind == "train" else 1) * micro
    if shape.kind == "train":
        byts += (4 * Np / chips) * 8                   # grads+adam m,v RW f32
    cache_rw_global = 0.0
    if decode:
        kv_bytes = 1 if cfg.kv_quant else 2
        for k in layers:
            slots = None
            if k in ("attn", "moe"):
                slots = S
            elif k in ("local", "local_moe"):
                slots = min(cfg.window, S)
            elif k in ("mamba", "mamba_attn"):
                d_in = cfg.ssm_expand * d
                cache_rw_global += 2 * B * (d_in // cfg.ssm_head_dim) * \
                    cfg.ssm_state * cfg.ssm_head_dim * 4
                slots = S if k == "mamba_attn" else None
            elif k == "mlstm":
                d_in = cfg.mlstm_expand * d
                dv = d_in // cfg.n_heads
                dk = max(dv // 2, 8)
                cache_rw_global += 2 * B * cfg.n_heads * dk * dv * 4
            else:   # slstm
                cache_rw_global += 8 * B * d * 4
            if slots is not None:
                # k+v read once per step (+2% for scales / the write)
                cache_rw_global += (B * slots * cfg.eff_kv_heads *
                                    cfg.head_dim * kv_bytes * 2 * 1.02)
    cache_rw = cache_rw_global / chips
    byts += act_stream + cache_rw

    # ---- collectives ----------------------------------------------------
    coll = 0.0
    if shape.kind == "train":
        coll += 3 * micro * param_bytes_dev            # FSDP gathers
        coll += 4 * Np / chips                         # grad reduce-scatter
    elif not decode:
        coll += param_bytes_dev                        # prefill FSDP gathers
    # decode runs weight-stationary (§Perf): no weight movement at all —
    # only the small activation all-reduces below
    # TP activation all-reduces: 2 per block of the per-device token slice
    coll += 2 * len(layers) * tokens_dev * d * 2 * \
        (0.0 if model_shards == 1 else 1.0)
    if decode:                                          # ws partial-sum ARs
        coll += 2 * len(layers) * B * d * 2
    if cfg.n_experts:
        # MoE all-to-all: dispatch + combine buffers (capacity-padded)
        coll += (2 * tokens_dev * cfg.top_k * cfg.capacity_factor * d * 2 *
                 sum(k in ("moe", "local_moe") for k in layers))
    if decode and B < data_shards:                     # context parallelism
        coll += len(layers) * cfg.eff_kv_heads * cfg.head_dim * 4 * 2

    return AnalyticCosts(
        flops=flops_dev, bytes=byts, collective_bytes=coll,
        detail={"fwd_flops_global": fwd, "mult": mult,
                "param_bytes_dev": param_bytes_dev,
                "act_stream": act_stream, "cache_rw": cache_rw,
                "microbatches": micro,
                "model_flops_global": (6 if shape.kind == "train" else 2) *
                n_active_params(cfg) * B * S_q})


__all__ = ["AnalyticCosts", "analytic_costs"]
