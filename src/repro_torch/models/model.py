"""The LM: embed -> blocks -> final norm -> logits.

The port of the JAX package's ``models/model.py``; one code path serves all
ten architectures.  The reference stacks each position of the layer pattern
over its repetitions and runs a ``lax.scan``; here a Python loop walks the
layers in the same order (repetition by repetition, then the remainder), and
parameters and caches are **unstacked**: ``params["layers"][i]`` and
``caches["layers"][i]`` belong to layer ``i`` (:func:`layer_kinds` gives its
kind).  zamba2's weight-shared attention block is one set under
``params["shared"]``, as in the reference.
:func:`~repro_torch.models.convert.params_from_jax` maps the reference's
tree onto this layout.

Public API:
  model_spec(cfg)                -> ParamSpec tree (init source)
  init(cfg, gen, device[, dtype]) -> params  (dtype=float32: the masters)
  n_params(cfg), n_active_params(cfg)
  backbone(params, batch, cfg)   -> (hidden, aux)         [train]
  forward(params, batch, cfg)    -> (logits, aux)         [train/prefill]
  loss_fn(params, batch, cfg)    -> scalar loss           [train]
  init_caches(cfg, B, max_len, dtype, device) -> decode cache tree
  decode_step(params, tokens, caches, cache_len, cfg)
                                 -> (logits, caches)      [one token]
  prefill(params, batch, caches, cfg) -> (logits, caches) [fill caches]

Caches are written in place (``decode_step`` and ``prefill`` return the tree
they were given); the cacheless training path writes none.  Training
differentiates :func:`loss_fn` with autograd; ``cfg.remat`` picks what each
repetition of the layer pattern keeps for the backward
(:func:`_maybe_remat`).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..device import DeviceLike
from ..sharding.rules import ParamSpec, init_params, param_count, tree_map
from .blocks import (MOE_KINDS, block_apply, block_spec, init_block_cache,
                     shared_block_spec)
from .layers import (embed_scale, embed_spec, embed_tokens, lm_head_apply,
                     lm_head_spec, rms_norm, rms_norm_spec)
from .moe import moe_spec


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------
def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Block kind of each layer, in the reference's order: the pattern once
    per repetition, then the remainder."""
    return list(cfg.layer_pattern) * cfg.scan_reps + \
        list(cfg.remainder_pattern)


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    spec = {
        "embed": embed_spec(cfg),
        "final_norm": rms_norm_spec(cfg.d_model),
        "head": lm_head_spec(cfg),
        "layers": [block_spec(kind, cfg) for kind in layer_kinds(cfg)],
    }
    if "mamba_attn" in cfg.layer_pattern + cfg.remainder_pattern:
        spec["shared"] = shared_block_spec(cfg)
    return spec


def storage_dtype(spec: ParamSpec, cfg: ModelConfig) -> torch.dtype:
    """Norm scales and the other 1-D leaves, and the matrices whose spec
    says ``float32`` (those the reference reads in float32 from its float32
    masters: the MoE router, sLSTM's recurrent ``R``), are stored in
    float32; every other matmul weight once in the compute dtype — what the
    reference casts its float32 masters to on each call."""
    if len(spec.shape) == 1 or spec.float32:
        return torch.float32
    return cfg.compute_dtype


def init(cfg: ModelConfig, gen: torch.Generator, device: DeviceLike = None,
         dtype: Optional[torch.dtype] = None):
    """Parameters drawn from ``gen`` (a generator on ``device``, default the
    card), each leaf stored in :func:`storage_dtype`.  ``dtype`` is the
    dtype of the matmul weights instead: ``torch.float32`` draws float32
    masters, every leaf in float32, as the reference's ``init`` does — what
    training updates; each call casts them to the compute dtype."""
    def leaf_dtype(s: ParamSpec) -> torch.dtype:
        want = storage_dtype(s, cfg)
        return want if dtype is None or want == torch.float32 else dtype
    return init_params(gen, model_spec(cfg), leaf_dtype, device)


def n_params(cfg: ModelConfig) -> int:
    return param_count(model_spec(cfg))


def n_active_params(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: top_k of n_experts)."""
    total = param_count(model_spec(cfg))
    if cfg.n_experts and cfg.top_k:
        n_moe_layers = sum(k in MOE_KINDS for k in layer_kinds(cfg))
        expert_part = param_count(moe_spec(cfg)) - cfg.d_model * cfg.n_experts
        inactive = expert_part * (1 - cfg.top_k / cfg.n_experts)
        total -= int(n_moe_layers * inactive)
    return total


# ---------------------------------------------------------------------------
# forward and loss (train / prefill without cache)
# ---------------------------------------------------------------------------
def _embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.frontend is not None and "frontend_embeds" in batch:
        ct = cfg.compute_dtype
        fe = batch["frontend_embeds"].to(ct) @ \
            params["embed"]["frontend_proj"].to(ct)
        x = torch.cat([fe, x], dim=1)
    return x * embed_scale(cfg.d_model, x.dtype).to(x.device)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: keep the outputs of the matmuls with no batch
    dimension (``aten.mm``/``addmm``: a weight times the flattened tokens)
    and recompute the rest — the reference's
    ``checkpoint_dots_with_no_batch_dims``.  Batched products (attention's
    einsums, the ELL experts' ``bmm``) are recomputed, as there."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``: ``"none"`` keeps every activation for
    the backward, ``"full"`` keeps only ``fn``'s inputs and recomputes the
    rest (non-reentrant ``torch.utils.checkpoint``), ``"dots"`` keeps the
    unbatched matmuls' outputs too (:func:`_save_dots`).  A recompute runs
    ``fn`` again with the same inputs, so the MoE dispatch reads the same
    group sizes and ``"auto"`` takes the same branch."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=context)
    if cfg.remat != "full":
        raise ValueError(f"remat={cfg.remat!r}: none | dots | full")
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _layers(params, cfg: ModelConfig, x, aux, first: int, stop: int,
            caches=None, cache_len=None):
    """Layers ``first`` to ``stop - 1``; returns (x, aux)."""
    shared = params.get("shared")
    kinds = layer_kinds(cfg)
    for i in range(first, stop):
        x, _, a = block_apply(
            kinds[i], cfg, params["layers"][i], x, shared_params=shared,
            cache=None if caches is None else caches["layers"][i],
            cache_len=cache_len)
        aux = aux + a
    return x, aux


def _run_layers(params, x, cfg: ModelConfig, caches=None, cache_len=None):
    """Every layer, then the final norm.  Returns (x, aux).

    Without caches (training) each repetition of the layer pattern
    (``cfg.period`` layers, the reference's scanned ``rep_fn``) runs under
    :func:`_maybe_remat`; the remainder layers run outside it, as the
    reference's do."""
    run = functools.partial(_layers, params, cfg, caches=caches,
                            cache_len=cache_len)
    rep = run if caches is not None else _maybe_remat(run, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    period, reps = cfg.period, cfg.scan_reps
    for r in range(reps):
        x, aux = rep(x, aux, r * period, (r + 1) * period)
    x, aux = run(x, aux, reps * period, len(layer_kinds(cfg)))
    return rms_norm(params["final_norm"], x, cfg.norm_eps), aux


def backbone(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """embed -> blocks -> final norm.  Returns (hidden (B,S,d), aux)."""
    return _run_layers(params, _embed_inputs(params, batch, cfg), cfg)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B,S') [, "frontend_embeds": (B,F,d)]} ->
    (logits (B,S,V_pad), aux)."""
    x, aux = backbone(params, batch, cfg)
    return lm_head_apply(params.get("head"), params["embed"], x, cfg), aux


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            aux_weight: float = 0.01, seq_chunk: int = 512) -> torch.Tensor:
    """Causal LM loss; labels < 0 are masked (frontend positions, padding).

    The softmax cross-entropy runs over sequence chunks of ``seq_chunk``
    (one chunk when it does not divide the sequence), each under a
    checkpoint, so the (B, S, V) logits never exist at once: the backward
    recomputes one chunk's logits at a time."""
    nll, cnt, aux = loss_terms(params, batch, cfg, seq_chunk)
    return nll / cnt.clamp_min(1.0) + aux_weight * aux


def loss_terms(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               seq_chunk: int = 512):
    """The terms of :func:`loss_fn`: (summed token NLL, unmasked label
    count, auxiliary loss), float32 scalars — a step over a sharded batch
    sums the first two over the shards before it divides."""
    x, aux = backbone(params, batch, cfg)               # (B, S, d)
    labels = batch["labels"].long()
    if cfg.frontend is not None and "frontend_embeds" in batch:
        F = batch["frontend_embeds"].shape[1]
        pad = torch.full(labels.shape[:1] + (F,), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)

    B, S, d = x.shape
    chunk = min(seq_chunk, S)
    n_chunks = S // chunk if S % chunk == 0 else 1
    chunk = S // n_chunks

    def chunk_nll(x_c, y_c):
        logits = lm_head_apply(params.get("head"), params["embed"], x_c,
                               cfg).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y_c.clamp_min(0)[..., None])[..., 0]
        mask = (y_c >= 0).float()
        return ((logz - gold) * mask).sum(), mask.sum()

    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, chunk):
        n, k = checkpoint(chunk_nll, x[:, c:c + chunk],
                          labels[:, c:c + chunk], use_reentrant=False)
        nll, cnt = nll + n, cnt + k
    return nll, cnt, aux


# ---------------------------------------------------------------------------
# decode with caches
# ---------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device: DeviceLike = None) -> Dict[str, Any]:
    """One cache dict per layer.  The layers of the pattern's repetitions
    start from zero-filled caches, as the reference's do (its
    ``init_caches`` stacks them with ``jnp.zeros``): xLSTM's stabilizer
    ``m`` starts at 0 there, and at -1e30 only in remainder layers and
    in :func:`forward`.  Every other leaf starts at zero either way."""
    n_stacked = cfg.scan_reps * cfg.period
    caches = []
    for i, kind in enumerate(layer_kinds(cfg)):
        c = init_block_cache(kind, cfg, batch, max_len, dtype, device)
        if i < n_stacked:
            tree_map(torch.Tensor.zero_, c)
        caches.append(c)
    return {"layers": caches}


def decode_step(params, tokens: torch.Tensor, caches, cache_len,
                cfg: ModelConfig):
    """tokens: (B, 1) -> (logits (B,1,V), caches).  cache_len: an int or a
    (B,) tensor = positions already in the caches (per sequence)."""
    x = embed_tokens(params["embed"], tokens, cfg)
    x = x * embed_scale(cfg.d_model, x.dtype).to(x.device)
    x, _ = _run_layers(params, x, cfg, caches, cache_len)
    return lm_head_apply(params.get("head"), params["embed"], x, cfg), caches


def prefill(params, batch: Dict[str, torch.Tensor], caches, cfg: ModelConfig):
    """Fill caches from a fresh sequence; returns (logits, caches)."""
    x = _embed_inputs(params, batch, cfg)
    x, _ = _run_layers(params, x, cfg, caches, 0)
    return lm_head_apply(params.get("head"), params["embed"], x, cfg), caches


__all__ = ["layer_kinds", "model_spec", "storage_dtype",
           "init", "n_params", "n_active_params", "backbone", "forward",
           "loss_fn", "loss_terms", "init_caches", "decode_step", "prefill"]
