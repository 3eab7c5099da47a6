"""Shared NN layers: RMSNorm, RoPE, MLP, embeddings — spec + apply pairs.

The port of the JAX package's ``models/layers.py``.  Every module is a
(``*_spec``, ``*_apply``) pair with the reference's shapes and names.  The
reference keeps float32 masters and casts each weight to the compute dtype
on every call; the port stores matmul weights once in the compute dtype
(``model.storage_dtype``), which gives the same numbers, and norm scales in
float32 (:func:`rms_norm` reads them in float32 either way)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding.rules import ParamSpec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rms_norm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), (None,), init="ones")}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    angles = positions[..., None].float() * freqs             # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, ff), ("embed", "ffn")),
        "w_up": ParamSpec((d, ff), ("embed", "ffn")),
        "w_down": ParamSpec((ff, d), ("ffn", "embed")),
    }


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    ct = cfg.compute_dtype
    h = F.silu(x @ params["w_gate"].to(ct)) * (x @ params["w_up"].to(ct))
    return h @ params["w_down"].to(ct)


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------
def padded_vocab(cfg: ModelConfig, mult: int = 128) -> int:
    """Vocab rounded up to a multiple of ``mult``, as in the reference (whose
    shardings need it).  Extra rows are never indexed; extra logit columns
    are masked in :func:`lm_head_apply`, so the model function is
    unchanged."""
    return ((cfg.vocab_size + mult - 1) // mult) * mult


def embed_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    axes = (None, "embed_tp") if cfg.embed_tp_lookup else ("vocab", "embed")
    spec = {"tok": ParamSpec((padded_vocab(cfg), cfg.d_model),
                             axes, init="embed")}
    if cfg.frontend is not None:
        # stub frontend projection: precomputed patch/frame embeddings
        # (d_frontend == d_model for the stub) -> model space
        spec["frontend_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                          ("embed", "embed_act"))
    return spec


def embed_tokens(params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return params["tok"].to(cfg.compute_dtype)[tokens]


def embed_scale(d_model: int, dtype: torch.dtype) -> torch.Tensor:
    """``sqrt(d_model)`` in float32, then in ``dtype`` — the reference's
    ``jnp.sqrt(float(d)).astype(x.dtype)``."""
    return torch.tensor(float(np.sqrt(np.float32(d_model))),
                        dtype=torch.float32).to(dtype)


def lm_head_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    if cfg.tie_embeddings:
        return {}
    return {"w": ParamSpec((cfg.d_model, padded_vocab(cfg)),
                           ("embed", "vocab"))}


def lm_head_apply(head_params, embed_params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    ct = cfg.compute_dtype
    if cfg.tie_embeddings:
        logits = x @ embed_params["tok"].to(ct).T
    else:
        logits = x @ head_params["w"].to(ct)
    vp = padded_vocab(cfg)
    if vp != cfg.vocab_size:  # mask pad columns out of the softmax
        keep = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(keep, logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype,
                                          device=logits.device))
    return logits


__all__ = ["rms_norm_spec", "rms_norm", "rope_freqs", "apply_rope",
           "mlp_spec", "mlp_apply", "padded_vocab", "embed_spec",
           "embed_tokens", "embed_scale", "lm_head_spec", "lm_head_apply"]
