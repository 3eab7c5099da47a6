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
``tp_*``); with ``tp == 1`` every one of them is the one-device code.
Sequence-parallel (``MeshContext.seq_split``), the residual stream is the
rank's shard of the sequence: gathered before the column-parallel
products, reduce-scattered after the row-parallel one.  Weight-stationary
(``MeshContext.ws``), each weight is also its FSDP shard of ``d`` and the
residual stream the rank's columns of it: a product that contracts ``d``
is a partial sum over the FSDP axes (``data_sum``), one that produces
``d`` gives the rank's columns, and :func:`residual_norm` sums its squares
over the FSDP axes."""
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


def residual_norm(params, x: torch.Tensor, eps: float = 1e-5
                  ) -> torch.Tensor:
    """:func:`rms_norm` of the residual stream ``(B, S, d)`` as the step
    holds it: under ``ws`` its columns of ``d`` (the sum of squares summed
    over the FSDP axes, the scale read at those columns); with the
    sequence split over ``model`` the rank's positions (the scale's
    gradient is then partial on each rank: summed over ``model``)."""
    mc = mesh_context()
    scale = params["scale"]
    if mc.seq_split:
        scale = C.tp_copy(scale, mc)
    full = scale.shape[-1]
    lo, hi = mc.embed_cols(full)
    if (lo, hi) == (0, full):
        return rms_norm({"scale": scale}, x, eps)
    x32 = x.float()
    var = C.data_sum((x32 * x32).sum(dim=-1, keepdim=True), mc) / full
    return (x32 * torch.rsqrt(var + eps) * scale.float()[lo:hi]).to(x.dtype)


def data_sums(*outs: torch.Tensor) -> list:
    """The partial products ``outs`` (each contracting ``d``) as they are;
    under ``ws``, where each is the rank's part of a product over its
    columns and rows of ``d``, summed over the FSDP axes in one
    collective."""
    mc = mesh_context()
    if not mc.data_groups:
        return list(outs)
    sizes = [o.shape[-1] for o in outs]
    return list(C.data_sum(torch.cat(outs, dim=-1), mc).split(sizes, -1))


def data_products(x: torch.Tensor, *ws: torch.Tensor) -> list:
    """``x @ w`` for each ``w`` (each contracting ``d`` on its first dim),
    summed over the FSDP axes under ``ws`` (:func:`data_sums`)."""
    return data_sums(*(x @ w for w in ws))


def seq_shard(x: torch.Tensor, mc) -> torch.Tensor:
    """The rank's ``model`` shard of the sequence (dim 1) of ``x``; no
    communication (every rank holds ``x``)."""
    n = x.shape[1] // mc.tp
    return x.narrow(1, mc.tp_rank * n, n)


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
    and ``w_down`` row-parallel (a sum over ``model``, or a reduce-scatter
    over the sequence where it is split); weight-stationary, the first two
    contract the rank's columns of ``d`` (summed over the FSDP axes) and
    ``w_down`` gives them."""
    ct = cfg.compute_dtype
    mc = mesh_context()
    split = mc.splits(mlp_spec(cfg)["w_down"], 0)
    if mc.seq_split:
        if not split:
            raise ValueError("sequence parallelism needs the MLP's d_ff "
                             f"split over the model axis of {mc.tp}")
        x = C.seq_gather(x, mc)
    elif split:
        x = C.tp_copy(x, mc)
    g, u = data_products(x, params["w_gate"].to(ct), params["w_up"].to(ct))
    y = (F.silu(g) * u) @ params["w_down"].to(ct)
    if mc.seq_split:
        return C.seq_scatter(y, mc)
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


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 seq_split: bool = False,
                 prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The token embedding.  On a mesh the table is the rank's ``model``
    shard: of its rows (vocabulary-parallel: the rank's tokens looked up,
    zeros for the others, summed over ``model``) or, with
    ``embed_tp_lookup``, of its columns (every token's slice of ``d``,
    gathered over ``model``).  Weight-stationary the table is also its
    FSDP shard of ``d``: each token's columns of the rank.  ``seq_split``:
    the rank's shard of the sequence (the vocabulary-parallel partial sums
    reduce-scattered over it).  ``prefix`` ``(B, F, d)``, the same on
    every rank (frontend embeddings), goes before the tokens along the
    sequence (used with ``seq_split``: counted once in the reduce-scatter,
    its gradient summed over ``model``)."""
    tok = params["tok"].to(cfg.compute_dtype)
    spec = embed_spec(cfg)["tok"]
    mc = mesh_context()

    def whole(x):       # a replicated lookup: the prefix, the rank's shard
        if prefix is not None:  # (each rank's gradient of it partial)
            x = torch.cat([C.tp_copy(prefix, mc) if seq_split else prefix,
                           x], dim=1)
        return seq_shard(x, mc) if seq_split else x
    if mc.splits(spec, 1):                    # embed_tp_lookup: d sharded
        x = C.tp_gather(tok[tokens], -1, mc, grad_sum=seq_split)
        if mc.ws:
            lo, hi = mc.embed_cols(cfg.d_model)
            x = x[..., lo:hi]
        return whole(x)
    lo, hi = mc.shard(spec, 0)
    if hi - lo == spec.shape[0]:
        return whole((C.tp_copy(tok, mc) if seq_split else tok)[tokens])
    mine = (tokens >= lo) & (tokens < hi)
    x = tok[(tokens - lo).clamp(0, hi - lo - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    if not seq_split:
        x = C.tp_reduce(x, mc)
        return x if prefix is None else torch.cat([prefix, x], dim=1)
    if prefix is not None:
        once = torch.tensor(float(mc.tp_rank == 0), dtype=prefix.dtype,
                            device=prefix.device)
        x = torch.cat([C.tp_copy(prefix, mc) * once, x], dim=1)
    return C.seq_scatter(x, mc)


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
                  cfg: ModelConfig, copy: bool = True) -> torch.Tensor:
    """Logits over the padded vocabulary.  On a mesh they are the rank's
    ``model`` slice of it (vocabulary-parallel: :func:`vocab_span` says
    which columns); a tied table sharded over ``d`` (``embed_tp_lookup``)
    gives every column, its partial products summed over ``model``.
    ``copy=False``: ``x``'s gradient is left partial on each ``model``
    rank (it came from :func:`~repro_torch.sharding.collectives.seq_gather`,
    whose backward sums it).  Weight-stationary ``x`` is the rank's
    columns of ``d`` and the partial logits are summed over the FSDP
    axes."""
    ct = cfg.compute_dtype
    mc = mesh_context()
    w = embed_params["tok"].to(ct).T if cfg.tie_embeddings else \
        head_params["w"].to(ct)
    vp = padded_vocab(cfg)
    tok = embed_spec(cfg)["tok"]
    lo, hi = vocab_span(cfg)
    if cfg.tie_embeddings and mc.splits(tok, 1):    # tied, d sharded
        if mc.data_groups:      # the table's d is split over model only
            x = C.data_gather(x, -1, mc.data_groups)
        d0, d1 = mc.shard(tok, 1)
        logits = C.tp_reduce((C.tp_copy(x, mc) if copy else x)
                             [..., d0:d1] @ w, mc)
    elif hi - lo != vp:                       # vocabulary-parallel
        logits = data_products(C.tp_copy(x, mc) if copy else x, w)[0]
    else:
        logits = data_products(x, w)[0]
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


__all__ = ["rms_norm_spec", "rms_norm", "residual_norm", "data_sums",
           "data_products", "seq_shard", "rope_freqs", "apply_rope",
           "mlp_spec", "mlp_apply", "padded_vocab", "embed_spec",
           "embed_tokens", "embed_scale", "lm_head_spec", "lm_head_apply",
           "vocab_span"]
