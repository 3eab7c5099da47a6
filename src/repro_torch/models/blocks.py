"""Block kinds: spec/apply/cache-init triples, composed by ``model.py``.

The port of the JAX package's ``models/blocks.py`` for the attention kinds
``attn`` (global attention + MLP) and ``local`` (sliding-window attention
with a ring-buffer cache + MLP):

    x += Attn(LN(x)); x += MLP(LN(x))

The other kinds of the reference (``moe``, ``local_moe``, ``mamba``,
``mamba_attn``, ``mlstm``, ``slstm``) raise ``NotImplementedError``: they
are still to port (ROADMAP A16).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike
from .attention import (attention_apply, attention_spec, init_kv_cache,
                        kv_cache_len)
from .layers import mlp_apply, mlp_spec, rms_norm, rms_norm_spec

PORTED_KINDS = ("attn", "local")
UNPORTED_KINDS = ("moe", "local_moe", "mamba", "mamba_attn", "mlstm",
                  "slstm")


def _check_kind(kind: str) -> None:
    if kind in UNPORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported to PyTorch yet (ROADMAP "
            f"A16); the port runs {PORTED_KINDS}")
    if kind not in PORTED_KINDS:
        raise KeyError(kind)


def block_spec(kind: str, cfg: ModelConfig) -> Dict[str, Any]:
    _check_kind(kind)
    d = cfg.d_model
    return {"ln1": rms_norm_spec(d), "attn": attention_spec(cfg),
            "ln2": rms_norm_spec(d), "mlp": mlp_spec(cfg)}


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device: DeviceLike = None) -> Dict[str, Any]:
    _check_kind(kind)
    return {"attn": init_kv_cache(cfg, batch, kv_cache_len(cfg, kind, max_len),
                                  dtype, device=device)}


def block_apply(kind: str, cfg: ModelConfig, params, x: torch.Tensor, *,
                cache=None, cache_len=None
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, cache, aux_loss); a given cache is updated in place."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    window = cfg.window if kind == "local" else None
    theta = (cfg.rope_theta_global
             if kind == "attn" and cfg.rope_theta_global else None)
    h, kv = attention_apply(
        params["attn"], rms_norm(params["ln1"], x, cfg.norm_eps), cfg,
        window=window, rope_theta=theta,
        cache=None if cache is None else cache["attn"], cache_len=cache_len)
    x = x + h
    x = x + mlp_apply(params["mlp"], rms_norm(params["ln2"], x, cfg.norm_eps),
                      cfg)
    return x, (None if cache is None else {"attn": kv}), aux


__all__ = ["PORTED_KINDS", "block_spec", "init_block_cache", "block_apply"]
