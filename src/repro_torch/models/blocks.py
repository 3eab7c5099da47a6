"""Block kinds: spec/apply/cache-init triples, composed by ``model.py``.

The port of the JAX package's ``models/blocks.py``, every kind.  Residual
structure:

  attn/local[_moe]: x += Attn(LN(x)); x += MLP-or-MoE(LN(x))
  mamba[_attn]:     x += Mamba(LN(x)); [+ the zamba2 *shared* attn+MLP block]
  mlstm/slstm:      x += xLSTM(LN(x))   (projections live inside the block)

Caches are written in place; :func:`block_apply` returns the dict it was
given.  The norms before each sub-block read the residual stream as the
step holds it (``layers.residual_norm``): its columns of ``d`` under
weight-stationary serving, its shard of the sequence under sequence
parallelism (the attention, MLP and MoE kinds only).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ATTN_KINDS, ModelConfig
from ..device import DeviceLike
from .attention import (attention_apply, attention_spec, init_kv_cache,
                        kv_cache_len)
from ..sharding.rules import mesh_context
from .layers import mlp_apply, mlp_spec, residual_norm, rms_norm_spec
from .moe import moe_apply, moe_spec
from .ssm import init_mamba_cache, mamba_apply, mamba_spec
from .xlstm import (init_mlstm_cache, init_slstm_cache, mlstm_apply,
                    mlstm_spec, slstm_apply, slstm_spec)

MOE_KINDS = ("moe", "local_moe")


def block_spec(kind: str, cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    if kind in ("attn", "local"):
        return {"ln1": rms_norm_spec(d), "attn": attention_spec(cfg),
                "ln2": rms_norm_spec(d), "mlp": mlp_spec(cfg)}
    if kind in MOE_KINDS:
        return {"ln1": rms_norm_spec(d), "attn": attention_spec(cfg),
                "ln2": rms_norm_spec(d), "moe": moe_spec(cfg)}
    if kind in ("mamba", "mamba_attn"):
        return {"ln": rms_norm_spec(d), "mamba": mamba_spec(cfg)}
    if kind == "mlstm":
        return {"ln": rms_norm_spec(d), "mlstm": mlstm_spec(cfg)}
    if kind == "slstm":
        return {"ln": rms_norm_spec(d), "slstm": slstm_spec(cfg)}
    raise KeyError(kind)


def shared_block_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """zamba2's weight-shared attention block (one param set, many calls)."""
    d = cfg.d_model
    return {"ln1": rms_norm_spec(d), "attn": attention_spec(cfg),
            "ln2": rms_norm_spec(d), "mlp": mlp_spec(cfg)}


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device: DeviceLike = None) -> Dict[str, Any]:
    if kind in ATTN_KINDS:
        return {"attn": init_kv_cache(
            cfg, batch, kv_cache_len(cfg, kind, max_len), dtype,
            device=device)}
    if kind == "mamba":
        return {"mamba": init_mamba_cache(cfg, batch, dtype, device)}
    if kind == "mamba_attn":
        return {"mamba": init_mamba_cache(cfg, batch, dtype, device),
                "attn": init_kv_cache(cfg, batch, max_len, dtype,
                                      device=device)}
    if kind == "mlstm":
        return {"mlstm": init_mlstm_cache(cfg, batch, dtype, device)}
    if kind == "slstm":
        return {"slstm": init_slstm_cache(cfg, batch, dtype, device)}
    raise KeyError(kind)


def block_apply(kind: str, cfg: ModelConfig, params, x: torch.Tensor, *,
                shared_params=None, cache=None, cache_len=None
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, cache, aux_loss); a given cache is updated in place."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def sub(name):
        return None if cache is None else cache[name]

    if mesh_context().seq_split and kind not in ("attn", "local") + \
            MOE_KINDS:
        raise ValueError(f"a {kind!r} block runs over the whole sequence: "
                         f"its config must not ask for sequence "
                         f"parallelism (use_seq_sp=False)")

    def norm(p, x):
        return residual_norm(p, x, cfg.norm_eps)

    if kind in ATTN_KINDS:
        local = kind in ("local", "local_moe")
        theta = (cfg.rope_theta_global
                 if kind == "attn" and cfg.rope_theta_global else None)
        h, _ = attention_apply(
            params["attn"], norm(params["ln1"], x), cfg,
            window=cfg.window if local else None, rope_theta=theta,
            cache=sub("attn"), cache_len=cache_len)
        x = x + h
        h2_in = norm(params["ln2"], x)
        if kind in MOE_KINDS:
            h2, aux = moe_apply(params["moe"], h2_in, cfg)
        else:
            h2 = mlp_apply(params["mlp"], h2_in, cfg)
        return x + h2, cache, aux

    if kind in ("mamba", "mamba_attn"):
        h, _ = mamba_apply(params["mamba"], norm(params["ln"], x), cfg,
                           cache=sub("mamba"))
        x = x + h
        if kind == "mamba_attn":
            if shared_params is None:
                raise ValueError("mamba_attn needs the shared block's "
                                 "params (zamba2's params['shared'])")
            h, _ = attention_apply(
                shared_params["attn"], norm(shared_params["ln1"], x), cfg,
                cache=sub("attn"), cache_len=cache_len)
            x = x + h
            x = x + mlp_apply(shared_params["mlp"],
                              norm(shared_params["ln2"], x), cfg)
        return x, cache, aux

    if kind in ("mlstm", "slstm"):
        apply = mlstm_apply if kind == "mlstm" else slstm_apply
        h, _ = apply(params[kind], norm(params["ln"], x), cfg,
                     cache=sub(kind))
        return x + h, cache, aux

    raise KeyError(kind)


__all__ = ["block_spec", "shared_block_spec", "init_block_cache",
           "block_apply", "MOE_KINDS"]
