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
  init(cfg, gen, device)         -> params
  n_params(cfg), n_active_params(cfg)
  forward(params, batch, cfg)    -> (logits, aux)         [train/prefill]
  init_caches(cfg, B, max_len, dtype, device) -> decode cache tree
  decode_step(params, tokens, caches, cache_len, cfg)
                                 -> (logits, caches)      [one token]
  prefill(params, batch, caches, cfg) -> (logits, caches) [fill caches]

Caches are written in place (``decode_step`` and ``prefill`` return the tree
they were given).  ``loss_fn`` and rematerialization come with training.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

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


def init(cfg: ModelConfig, gen: torch.Generator, device: DeviceLike = None):
    """Parameters drawn from ``gen`` (a generator on ``device``, default the
    card), each leaf stored in :func:`storage_dtype`."""
    return init_params(gen, model_spec(cfg),
                       lambda s: storage_dtype(s, cfg), device)


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
# forward (prefill without cache)
# ---------------------------------------------------------------------------
def _embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.frontend is not None and "frontend_embeds" in batch:
        ct = cfg.compute_dtype
        fe = batch["frontend_embeds"].to(ct) @ \
            params["embed"]["frontend_proj"].to(ct)
        x = torch.cat([fe, x], dim=1)
    return x * embed_scale(cfg.d_model, x.dtype).to(x.device)


def _run_layers(params, x, cfg: ModelConfig, caches=None, cache_len=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared")
    for i, kind in enumerate(layer_kinds(cfg)):
        x, _, a = block_apply(
            kind, cfg, params["layers"][i], x, shared_params=shared,
            cache=None if caches is None else caches["layers"][i],
            cache_len=cache_len)
        aux = aux + a
    return rms_norm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B,S') [, "frontend_embeds": (B,F,d)]} ->
    (logits (B,S,V_pad), aux)."""
    x, aux = _run_layers(params, _embed_inputs(params, batch, cfg), cfg)
    return lm_head_apply(params.get("head"), params["embed"], x, cfg), aux


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
           "init", "n_params", "n_active_params", "forward", "init_caches",
           "decode_step", "prefill"]
