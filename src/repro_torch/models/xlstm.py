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

**On a mesh** (``sharding/rules.py:mesh_context``) the projections onto
the ``inner`` dim are the rank's ``model`` shards (column-parallel).  mLSTM
runs its ``H / tp`` heads where ``tp`` divides the heads (its caches hold
them; the norm over ``d_in`` sums its squares over ``model``; ``out_proj``
row-parallel); where it does not (xlstm-1.3b's 4 heads on 16), q, k and
the conv's output are gathered over ``model`` and the recurrence runs
whole on every rank of the group (its caches replicated), ``out_proj``
still row-parallel on the rank's rows.  sLSTM with ``R`` sharded over its
gate columns (``xlstm_shard_recurrent``) runs the rank's slice of every
head's units: the input projection is gathered over ``model`` once, the
hidden state once a step (``R`` needs all of it), the output once.
Weight-stationary (``MeshContext.ws``) the input projections contract the
rank's columns of ``d`` (summed over the FSDP axes), the recurrence runs on
the batch rows whose states the rank holds (``MeshContext.span``; all of
them where the batch does not split), its output is gathered over those
rows, and ``out_proj`` gives the rank's columns of ``d`` (sLSTM's, whose
output dim is not split: its partial sums over the FSDP axes, then the
rank's columns).

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
from ..sharding import collectives as C
from ..sharding.rules import ParamSpec, mesh_context
from .layers import data_products, rms_norm
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
    S = x.shape[1]
    d_in, H, dk, dv = _mlstm_dims(cfg)
    mc = mesh_context()
    # sharded: the rank's columns of the inner dim; by_head: they are whole
    # heads (else the recurrence runs on every head, from gathered inputs)
    spec = mlstm_spec(cfg)
    sharded = mc.splits(spec["w_v"], 1)
    if sharded != mc.splits(spec["w_q"], 1):
        raise ValueError("mLSTM's w_q/w_k and w_v/w_z sharded unlike "
                         f"over a model axis of {mc.tp}")
    h0, h1 = mc.split(H) if sharded else (0, H)
    Hl = h1 - h0
    by_head = Hl != H
    xp = C.tp_copy(x, mc) if sharded else x
    z, q, k, v = data_products(xp, *(params[n].to(ct) for n in (
        "w_z", "w_q", "w_k", "w_v")))
    gates, = data_products(x, params["w_if"].to(ct))
    rows = None if cache is None else mc.span(cache["C"])
    if rows is not None:                 # the rank's batch rows
        z, q, k, v, gates = (t[rows[1]:rows[2]] for t in (z, q, k, v,
                                                           gates))
    B = z.shape[0]
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)
    if by_head:         # the gates are replicated: the rank's heads of them
        i_raw = C.tp_copy(i_raw, mc)[..., h0:h1]
        f_raw = C.tp_copy(f_raw, mc)[..., h0:h1]
    gathered = sharded and not by_head

    def full(t):        # the recurrence's inputs, every head
        return C.tp_gather(t, -1, mc) if gathered else t
    sqrt_dk = math.sqrt(float(dk))

    if cache is None or S > 1:
        vc = full(causal_conv(v, params["conv_w"].to(ct),
                              params["conv_b"].to(ct)))
        qs = full(q).reshape(B, S, Hl, dk).float()
        ks = full(k).reshape(B, S, Hl, dk).float() / sqrt_dk
        vs = vc.reshape(B, S, Hl, dv).float()
        gi = i_raw.reshape(B, S, Hl).float()
        gf = f_raw.reshape(B, S, Hl).float()
        if cache is None:
            dev = x.device
            carry = (torch.zeros((B, Hl, dk, dv), device=dev),
                     torch.zeros((B, Hl, dk), device=dev),
                     torch.full((B, Hl), STATE_INIT, device=dev))
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
        vc = full(conv_step(conv_win, params["conv_w"].to(ct),
                            params["conv_b"].to(ct)))
        qs = full(q[:, 0]).reshape(B, Hl, dk).float()
        ks = full(k[:, 0]).reshape(B, Hl, dk).float() / sqrt_dk
        vs = vc.reshape(B, Hl, dv).float()
        gi = i_raw[:, 0].reshape(B, Hl).float()
        gf = f_raw[:, 0].reshape(B, Hl).float()
        (mem, n, m), y1 = _mlstm_step((cache["C"], cache["n"], cache["m"]),
                                      (qs, ks, vs, gi, gf))
        y = y1[:, None]                                      # (B,1,H,dv)
        _write(cache, {"C": mem, "n": n, "m": m, "conv": conv_win[:, 1:]})

    y = y.reshape(B, S, Hl * dv).to(ct)
    y = rms_norm({"scale": params["norm"]}, y, cfg.norm_eps,
                 cols=(h0 * dv, h1 * dv))
    if gathered:        # the rank's rows of out_proj: its slice of y
        lo, hi = mc.shard(spec["out_proj"], 0)
        y = C.tp_copy(y, mc)[..., lo:hi]
    y = y * F.silu(z)
    if rows is not None:
        y = C.data_gather(y, 0, rows[4])
    y = y @ params["out_proj"].to(ct)
    return (C.tp_reduce(y, mc) if sharded else y), cache


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


def _slstm_step(R, carry, wx, h_all=None):
    """wx: (B, H, dh, 4) pre-activations from the input projection, gates
    interleaved on the last axis (z, i, f, o).  ``h_all``: the hidden
    state of every unit, where ``R`` and the carry hold the rank's units
    of each head."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,hde->bhe", h if h_all is None else h_all, R)
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
    S, d = x.shape[1], cfg.d_model
    H, dh = _slstm_dims(cfg)
    mc = mesh_context()
    spec = slstm_spec(cfg)
    R = params["R"].float()
    r0, r1 = mc.shard(spec["R"], 2)      # the rank's units of each head
    if r0 % 4 or r1 % 4:
        raise ValueError(f"sLSTM's R sharded over a model axis of {mc.tp} "
                         f"cuts a unit's four gates ({r1 - r0} of "
                         f"{4 * dh} columns)")
    u0, u1 = r0 // 4, r1 // 4
    units, mine = u1 - u0, u1 - u0 != dh
    w_in = params["in_proj"]
    if mc.splits(spec["in_proj"], 1):    # the rank's columns: gathered
        wx = C.tp_gather(data_products(C.tp_copy(x, mc), w_in.to(ct))[0],
                         -1, mc, mine)
    else:
        wx = data_products(x, w_in.to(ct))[0]
        if mine:                         # read at the rank's units only
            wx = C.tp_copy(wx, mc)
    rows = None if cache is None else mc.span(cache["c"])
    if rows is not None:                 # the rank's batch rows
        wx = wx[rows[1]:rows[2]]
    B = wx.shape[0]
    wx = wx.float().reshape(B, S, H, dh, 4)
    if mine:
        wx = wx[:, :, :, u0:u1]

    if cache is None:
        z0 = torch.zeros((B, H, units), device=x.device)
        carry = (z0, z0, z0, torch.full((B, H, units), STATE_INIT,
                                        device=x.device))
    else:
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])

    def every_unit(h):                   # R reads every unit of a head
        return C.tp_gather(h, -1, mc, True) if mine else None
    ys = []
    for t in range(S):
        carry, h_t = _slstm_step(R, carry, wx[:, t], every_unit(carry[2]))
        ys.append(h_t)
    y = torch.stack(ys, dim=1)                               # (B,S,H,dh)
    if cache is not None:
        _write(cache, dict(zip(("c", "n", "h", "m"), carry)))
    if mine:
        y = C.tp_gather(y, -1, mc)
    if rows is not None:
        y = C.data_gather(y, 0, rows[4])

    y = y.reshape(y.shape[0], S, d).to(ct)
    y = rms_norm({"scale": params["norm"]}, y, cfg.norm_eps)
    lo, hi = mc.embed_cols(d)
    if (lo, hi) == (0, d):
        return y @ params["out_proj"].to(ct), cache
    # out_proj's rows are the rank's columns of d, its columns whole
    return data_products(y[..., lo:hi], params["out_proj"].to(ct))[0][
        ..., lo:hi], cache


__all__ = ["mlstm_spec", "mlstm_apply", "init_mlstm_cache",
           "slstm_spec", "slstm_apply", "init_slstm_cache"]
