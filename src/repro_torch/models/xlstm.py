"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, exp input gate
with a max stabilizer) and sLSTM (scalar memory with true recurrence and
per-head block-diagonal recurrent weights).

The port of the JAX package's ``models/xlstm.py``.  mLSTM per head (state
C: (dk, dv), normalizer n: (dk,), stabilizer m):

    m_t = max(logsig(f~) + m_{t-1}, i~_t)
    f'  = exp(logsig(f~) + m_{t-1} - m_t);   i' = exp(i~ - m_t)
    C_t = f' C_{t-1} + i' k_t (x) v_t;       n_t = f' n_{t-1} + i' k_t
    y_t = (q_t . C_t) / max(|q_t . n_t|, 1)

Both kinds run their step in a Python loop over time at prefill and in
training, where the reference scans with two-level rematerialization
(``scan_chunked_remat``): autograd keeps every step's state of a layer for
its backward, so a long training sequence holds O(S) states per layer
(``remat="full"`` bounds that to the layers being recomputed).  All state
is float32, sLSTM's ``R`` included (stored in
float32: its spec says ``float32``); the conv cache is in the cache dtype.  A
given cache is written in place.

Plain PyTorch throughout: the reference computes these outside any Pallas
kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..sharding.rules import ParamSpec
from .layers import rms_norm
from .ssm import causal_conv, conv_step

STATE_INIT = -1e30      # the stabilizer m before the first step


def _write(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]):
    for name, value in new.items():
        cache[name].copy_(value)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.mlstm_expand * cfg.d_model
    H = cfg.n_heads
    dv = d_in // H
    dk = max(dv // 2, 8)
    return d_in, H, dk, dv


def mlstm_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in, H, dk, dv = _mlstm_dims(cfg)
    return {
        "w_z": ParamSpec((d, d_in), ("embed", "inner")),
        "w_q": ParamSpec((d, H * dk), ("embed", "inner")),
        "w_k": ParamSpec((d, H * dk), ("embed", "inner")),
        "w_v": ParamSpec((d, d_in), ("embed", "inner")),
        "w_if": ParamSpec((d, 2 * H), ("embed", None)),
        "conv_w": ParamSpec((4, d_in), ("conv", "inner")),
        "conv_b": ParamSpec((d_in,), ("inner",), init="zeros"),
        "norm": ParamSpec((d_in,), (None,), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("inner", "embed")),
    }


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    d_in, H, dk, dv = _mlstm_dims(cfg)
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "C": torch.zeros((batch, H, dk, dv), **f32),
        "n": torch.zeros((batch, H, dk), **f32),
        "m": torch.full((batch, H), STATE_INIT, **f32),
        "conv": torch.zeros((batch, 3, d_in), dtype=dtype, device=dev),
    }


def _mlstm_step(carry, xs):
    C, n, m = carry
    q, k, v, i_raw, f_raw = xs     # q,k: (B,H,dk); v: (B,H,dv); gates (B,H)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    f_p = torch.exp(logf + m - m_new)
    i_p = torch.exp(i_raw - m_new)
    C_new = f_p[..., None, None] * C + i_p[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C_new)
    den = torch.einsum("bhk,bhk->bh", q, n_new).abs()
    y = num / den.clamp_min(1.0)[..., None]
    return (C_new, n_new, m_new), y


def mlstm_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    ct = cfg.compute_dtype
    B, S, d = x.shape
    d_in, H, dk, dv = _mlstm_dims(cfg)
    z = x @ params["w_z"].to(ct)
    q = x @ params["w_q"].to(ct)
    k = x @ params["w_k"].to(ct)
    v = x @ params["w_v"].to(ct)
    i_raw, f_raw = torch.chunk(x @ params["w_if"].to(ct), 2, dim=-1)
    sqrt_dk = math.sqrt(float(dk))

    if cache is None or S > 1:
        vc = causal_conv(v, params["conv_w"].to(ct), params["conv_b"].to(ct))
        qs = q.reshape(B, S, H, dk).float()
        ks = k.reshape(B, S, H, dk).float() / sqrt_dk
        vs = vc.reshape(B, S, H, dv).float()
        gi = i_raw.reshape(B, S, H).float()
        gf = f_raw.reshape(B, S, H).float()
        if cache is None:
            dev = x.device
            carry = (torch.zeros((B, H, dk, dv), device=dev),
                     torch.zeros((B, H, dk), device=dev),
                     torch.full((B, H), STATE_INIT, device=dev))
        else:
            carry = (cache["C"], cache["n"], cache["m"])
        ys = []
        for t in range(S):
            carry, y_t = _mlstm_step(carry, (qs[:, t], ks[:, t], vs[:, t],
                                             gi[:, t], gf[:, t]))
            ys.append(y_t)
        y = torch.stack(ys, dim=1)                           # (B,S,H,dv)
        if cache is not None:  # prefill
            tail = torch.cat([cache["conv"], v.to(cache["conv"].dtype)],
                             dim=1)[:, -3:, :]
            _write(cache, {"C": carry[0], "n": carry[1], "m": carry[2],
                           "conv": tail})
    else:
        conv_win = torch.cat([cache["conv"], v.to(cache["conv"].dtype)],
                             dim=1)
        vc = conv_step(conv_win, params["conv_w"].to(ct),
                       params["conv_b"].to(ct))
        qs = q[:, 0].reshape(B, H, dk).float()
        ks = k[:, 0].reshape(B, H, dk).float() / sqrt_dk
        vs = vc.reshape(B, H, dv).float()
        gi = i_raw[:, 0].reshape(B, H).float()
        gf = f_raw[:, 0].reshape(B, H).float()
        (C, n, m), y1 = _mlstm_step((cache["C"], cache["n"], cache["m"]),
                                    (qs, ks, vs, gi, gf))
        y = y1[:, None]                                      # (B,1,H,dv)
        _write(cache, {"C": C, "n": n, "m": m, "conv": conv_win[:, 1:]})

    y = y.reshape(B, S, d_in).to(ct)
    y = rms_norm({"scale": params["norm"]}, y, cfg.norm_eps)
    y = y * F.silu(z)
    return y @ params["out_proj"].to(ct), cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def _slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    H = cfg.n_heads
    return H, cfg.d_model // H


def slstm_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    H, dh = _slstm_dims(cfg)
    r_axes = (None, None, "inner") if cfg.xlstm_shard_recurrent \
        else (None, None, None)
    return {
        "in_proj": ParamSpec((d, 4 * d), ("embed", "inner")),   # z,i,f,o
        "R": ParamSpec((H, dh, 4 * dh), r_axes, scale=0.1,      # recurrent
                       float32=True),
        "norm": ParamSpec((d,), (None,), init="ones"),
        "out_proj": ParamSpec((d, d), ("embed", "embed_act")),
    }


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    H, dh = _slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return {"c": torch.zeros((batch, H, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "h": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H, dh), STATE_INIT, **f32)}


def _slstm_step(R, carry, wx):
    """wx: (B, H, dh, 4) pre-activations from the input projection, gates
    interleaved on the last axis (z, i, f, o)."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,hde->bhe", h, R)                 # (B,H,4*dh)
    B, H, dh4 = rec.shape
    pre = wx + rec.reshape(B, H, dh4 // 4, 4)
    z_t = torch.tanh(pre[..., 0])
    i_raw = pre[..., 1]
    f_raw = pre[..., 2]
    o_t = torch.sigmoid(pre[..., 3])
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    f_p = torch.exp(logf + m - m_new)
    i_p = torch.exp(i_raw - m_new)
    c_new = f_p * c + i_p * z_t
    n_new = f_p * n + i_p
    h_new = o_t * c_new / n_new.clamp_min(1.0)
    return (c_new, n_new, h_new, m_new), h_new


def slstm_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    ct = cfg.compute_dtype
    B, S, d = x.shape
    H, dh = _slstm_dims(cfg)
    wx = (x @ params["in_proj"].to(ct)).float().reshape(B, S, H, dh, 4)
    R = params["R"].float()

    if cache is None:
        z0 = torch.zeros((B, H, dh), device=x.device)
        carry = (z0, z0, z0, torch.full((B, H, dh), STATE_INIT,
                                        device=x.device))
    else:
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    ys = []
    for t in range(S):
        carry, h_t = _slstm_step(R, carry, wx[:, t])
        ys.append(h_t)
    y = torch.stack(ys, dim=1)                               # (B,S,H,dh)
    if cache is not None:
        _write(cache, dict(zip(("c", "n", "h", "m"), carry)))

    y = y.reshape(B, S, d).to(ct)
    y = rms_norm({"scale": params["norm"]}, y, cfg.norm_eps)
    return y @ params["out_proj"].to(ct), cache


__all__ = ["mlstm_spec", "mlstm_apply", "init_mlstm_cache",
           "slstm_spec", "slstm_apply", "init_slstm_cache"]
