"""Shared NN layers: RMSNorm, RoPE, MLP, embeddings — spec + apply pairs.

The port of the JAX package's ``models/layers.py``.  Every module is a
(``*_spec``, ``*_apply``) pair with the reference's shapes and names.  The
reference keeps float32 masters and casts each weight to the compute dtype
on every call; the port stores matmul weights once in the compute dtype
(``model.storage_dtype``), which gives the same numbers, and norm scales in
float32 (:func:`rms_norm` reads them in float32 either way).

Under a mesh step (``sharding/rules.py:mesh_context``) each weight is its
``model`` shard: the MLP is column- then row-parallel, the embedding and
the LM head vocabulary-parallel (``sharding/collectives.py``'s
``tp_*``); with ``tp == 1`` every one of them is the one-device code."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding import collectives as C
from ..sharding.rules import ParamSpec, mesh_context

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rms_norm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), (None,), init="ones")}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-5,
             cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """RMSNorm over the last dim.  ``cols``: ``(start, stop)``, the last
    dim is these columns of the scale's dim, this rank's share of it split
    over ``model``: the sum of squares is summed over the group, and the
    scale (replicated) is read at those columns."""
    x32 = x.float()
    full = params["scale"].shape[-1]
    if cols is None or cols == (0, full):
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        scale = params["scale"].float()
    else:
        mc = mesh_context()
        var = C.tp_sum((x32 * x32).sum(dim=-1, keepdim=True), mc) / full
        scale = C.tp_copy(params["scale"].float(), mc)[cols[0]:cols[1]]
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale).to(x.dtype)


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
    """SwiGLU; on a mesh ``w_gate``/``w_up`` column-parallel over ``ffn``
    and ``w_down`` row-parallel (a sum over ``model``)."""
    ct = cfg.compute_dtype
    mc = mesh_context()
    split = mc.splits(mlp_spec(cfg)["w_down"], 0)
    if split:
        x = C.tp_copy(x, mc)
    h = F.silu(x @ params["w_gate"].to(ct)) * (x @ params["w_up"].to(ct))
    y = h @ params["w_down"].to(ct)
    return C.tp_reduce(y, mc) if split else y


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
    """The token embedding.  On a mesh the table is the rank's ``model``
    shard: of its rows (vocabulary-parallel: the rank's tokens looked up,
    zeros for the others, summed over ``model``) or, with
    ``embed_tp_lookup``, of its columns (every token's slice of ``d``,
    gathered over ``model``)."""
    tok = params["tok"].to(cfg.compute_dtype)
    spec = embed_spec(cfg)["tok"]
    mc = mesh_context()
    if mc.splits(spec, 1):                    # embed_tp_lookup: d sharded
        return C.tp_gather(tok[tokens], -1, mc)
    lo, hi = mc.shard(spec, 0)
    if hi - lo == spec.shape[0]:
        return tok[tokens]
    mine = (tokens >= lo) & (tokens < hi)
    x = tok[(tokens - lo).clamp(0, hi - lo - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return C.tp_reduce(x, mc)


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
    """Logits over the padded vocabulary.  On a mesh they are the rank's
    ``model`` slice of it (vocabulary-parallel: :func:`vocab_span` says
    which columns); a tied table sharded over ``d`` (``embed_tp_lookup``)
    gives every column, its partial products summed over ``model``."""
    ct = cfg.compute_dtype
    mc = mesh_context()
    w = embed_params["tok"].to(ct).T if cfg.tie_embeddings else \
        head_params["w"].to(ct)
    vp = padded_vocab(cfg)
    tok = embed_spec(cfg)["tok"]
    lo, hi = vocab_span(cfg)
    if cfg.tie_embeddings and mc.splits(tok, 1):    # tied, d sharded
        d0, d1 = mc.shard(tok, 1)
        logits = C.tp_reduce(C.tp_copy(x, mc)[..., d0:d1] @ w, mc)
    elif hi - lo != vp:                       # vocabulary-parallel
        logits = C.tp_copy(x, mc) @ w
    else:
        logits = x @ w
    if vp != cfg.vocab_size:  # mask pad columns out of the softmax
        keep = torch.arange(lo, hi, device=logits.device) < cfg.vocab_size
        logits = torch.where(keep, logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype,
                                          device=logits.device))
    return logits


def vocab_span(cfg: ModelConfig) -> Tuple[int, int]:
    """``(start, stop)``: the columns of the padded vocabulary that
    :func:`lm_head_apply`'s logits hold (this rank's slice on a mesh)."""
    if cfg.tie_embeddings:
        return mesh_context().shard(embed_spec(cfg)["tok"], 0)
    return mesh_context().shard(lm_head_spec(cfg)["w"], 1)


__all__ = ["rms_norm_spec", "rms_norm", "rope_freqs", "apply_rope",
           "mlp_spec", "mlp_apply", "padded_vocab", "embed_spec",
           "embed_tokens", "embed_scale", "lm_head_spec", "lm_head_apply",
           "vocab_span"]
