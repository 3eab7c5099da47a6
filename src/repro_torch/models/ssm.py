"""Mamba-2 (SSD) block — zamba2's backbone.

The port of the JAX package's ``models/ssm.py``.  State-space recurrence per
head h with scalar decay:

    a_t = exp(dt_t * A_h)            (A_h < 0)
    H_t = a_t * H_{t-1} + dt_t * B_t (x) x_t        H: (state, head_dim)
    y_t = C_t . H_t + D_h * x_t

Prefill runs the *chunked* SSD algorithm (:func:`_ssd_chunked`: an
intra-chunk quadratic term plus the state carried between chunks, a Python
loop over chunks where the reference scans).  Decode is the one-step
recurrence with a (state x head_dim) cache per head plus a (conv_w-1)-deep
conv cache.  The ``h`` cache, ``dt``, ``A`` and every state stay float32; the
conv cache is in the cache dtype.  A given cache is written in place.

**On a mesh** (``sharding/rules.py:mesh_context``) a rank runs its
``H / tp`` heads where ``tp`` divides the heads (else all of them).  The
packed ``in_proj`` (``z | x | B | C | dt`` on one ``inner`` dim) and the
conv's ``x | B | C`` channels do not shard by head: a contiguous slice of
them straddles the segments.  So these two weights (and the conv's bias)
are gathered over ``model`` when the rules shard them, and each rank reads
the columns it needs: its heads' ``z``, ``x`` and ``dt``, and all of ``B``
and ``C`` (computed on every rank); their gradients are summed over
``model`` and sliced back (:func:`~repro_torch.sharding.collectives.tp_gather`
with ``grad_sum``).  The gated RMSNorm over ``d_in`` sums its squares over
``model``; ``out_proj`` is row-parallel.  The ``h`` cache holds the rank's
heads; the conv cache is replicated (every channel's last ``K - 1``
inputs, the new ``x`` channels gathered over ``model`` to write it).
Weight-stationary (``MeshContext.ws``) ``in_proj`` contracts the rank's
columns of ``d`` (summed over the FSDP axes), the recurrence runs on the
batch rows whose states the rank holds (``MeshContext.span``; all of them
where the batch does not split), its output is gathered over those rows
and ``out_proj`` gives the rank's columns of ``d``.

Plain PyTorch throughout: the reference computes these with einsums and a
``lax.scan`` outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..sharding import collectives as C
from ..sharding.rules import ParamSpec, mesh_context
from .layers import data_products, rms_norm


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_head_dim, cfg.ssm_state


def mamba_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in, H, hd, N = _dims(cfg)
    conv_ch = d_in + 2 * N
    return {
        # [z (d_in) | x (d_in) | B (N) | C (N) | dt (H)]
        "in_proj": ParamSpec((d, 2 * d_in + 2 * N + H), ("embed", "inner")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch), ("conv", "inner")),
        "conv_b": ParamSpec((conv_ch,), ("inner",), init="zeros"),
        "A_log": ParamSpec((H,), (None,), init="zeros"),
        "D": ParamSpec((H,), (None,), init="ones"),
        "dt_bias": ParamSpec((H,), (None,), init="zeros"),
        "norm": ParamSpec((d_in,), (None,), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("inner", "embed")),
    }


def causal_conv(u: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv then SiLU: u (B, L, C), w (K, C), b (C,)."""
    K, L = w.shape[0], u.shape[1]
    u_pad = F.pad(u, (0, 0, K - 1, 0))
    out = sum(u_pad[:, i:i + L, :] * w[i] for i in range(K))
    return F.silu(out + b)


def conv_step(conv_win: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """One step of :func:`causal_conv` over the window [cache | current]
    (B, K, C), in the promoted dtype of the cache and the weights (the
    reference's ``einsum`` promotes a float32 cache with bfloat16
    weights)."""
    dt = torch.promote_types(conv_win.dtype, w.dtype)
    co = torch.einsum("bkc,kc->bc", conv_win.to(dt), w.to(dt)) + b.to(dt)
    return F.silu(co)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    d_in, H, hd, N = _dims(cfg)
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, H, N, hd), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * N),
                            dtype=dtype, device=dev),
    }


def _packed(w: torch.Tensor, spec: ParamSpec, mc,
            grad_sum: bool) -> torch.Tensor:
    """A packed weight whole along its last dim: gathered over ``model``
    when the rules shard it (``grad_sum``: the ranks read different
    columns, so its gradient is summed over ``model``, then sliced back
    where the leaf is sharded)."""
    if mc.splits(spec, len(spec.shape) - 1):
        return C.tp_gather(w, -1, mc, grad_sum)
    return C.tp_copy(w, mc) if grad_sum else w


def _columns(w: torch.Tensor, spans) -> torch.Tensor:
    """The columns of ``w`` in the ``(start, stop)`` spans, in order."""
    return torch.cat([w[..., a:b] for a, b in spans], dim=-1)


def mamba_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[Dict[str, Any]] = None,
                chunk: int = 256) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d).  Train/prefill when cache is None (chunked SSD);
    prefill-and-fill when a cache is given and S > 1; one decode step when a
    cache is given and S == 1.  A given cache is written in place and
    returned.  On a mesh the rank's heads (module docstring)."""
    ct = cfg.compute_dtype
    S = x.shape[1]
    d_in, H, hd, N = _dims(cfg)
    mc = mesh_context()
    h0, h1 = mc.split(H)
    Hl, dl = h1 - h0, (h1 - h0) * hd
    split = Hl != H
    if split:
        x = C.tp_copy(x, mc)
    x_cols = (h0 * hd, h1 * hd)
    bc_cols = (d_in, d_in + 2 * N)
    spec = mamba_spec(cfg)
    w_in = _packed(params["in_proj"], spec["in_proj"], mc, split)
    conv_w = _packed(params["conv_w"], spec["conv_w"], mc, split)
    conv_b = _packed(params["conv_b"], spec["conv_b"], mc, split)
    if split:           # the rank's columns: z, x, B, C, dt
        w_in = _columns(w_in, [
            x_cols, (d_in + x_cols[0], d_in + x_cols[1]),
            (2 * d_in, 2 * d_in + 2 * N),
            (2 * d_in + 2 * N + h0, 2 * d_in + 2 * N + h1)])
        conv_w = _columns(conv_w, [x_cols, bc_cols])
        conv_b = _columns(conv_b, [x_cols, bc_cols])
    conv_w, conv_b = conv_w.to(ct), conv_b.to(ct)
    proj = data_products(x, w_in.to(ct))[0]
    rows = None if cache is None else mc.span(cache["h"])
    if rows is not None:                     # the rank's batch rows
        proj = proj[rows[1]:rows[2]]
    B = proj.shape[0]
    z, xin, Bm, Cm, dt_raw = torch.split(proj, [dl, dl, N, N, Hl], dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)

    def heads(p):       # a replicated (H,) leaf at the rank's heads
        return (C.tp_copy(p, mc)[h0:h1] if split else p).float()
    A = -torch.exp(heads(params["A_log"]))                      # (H,) < 0
    dt = F.softplus(dt_raw.float() + heads(params["dt_bias"]))  # (B,S,H)
    D = heads(params["D"])

    def conv_cache(new):
        """The conv cache's new inputs, every channel (the x channels of
        the other ranks' heads gathered)."""
        if not split:
            return new
        return torch.cat([C.tp_gather(new[..., :dl], -1, mc), new[..., dl:]],
                         dim=-1).to(cache["conv"].dtype)

    if cache is None or S > 1:
        conv_out = causal_conv(conv_in, conv_w, conv_b)
        xc, Bc, Cc = torch.split(conv_out, [dl, N, N], dim=-1)
        xh = xc.reshape(B, S, Hl, hd).float()
        y, h_fin = _ssd_chunked(xh, Bc.float(), Cc.float(), dt, A,
                                chunk=chunk,
                                h0=None if cache is None else cache["h"])
        y = y + D[None, None, :, None] * xh
        if cache is not None:  # prefill: final SSM state + last (K-1) inputs
            K = cfg.ssm_conv
            tail = torch.cat([cache["conv"], conv_cache(
                conv_in[:, -(K - 1):]).to(cache["conv"].dtype)],
                dim=1)[:, -(K - 1):, :]
            cache["h"].copy_(h_fin)
            cache["conv"].copy_(tail)
    else:
        # decode: conv over [cache | current], one recurrence step
        past = cache["conv"]
        if split:
            past = _columns(past, [x_cols, bc_cols])
        conv_win = torch.cat([past, conv_in.to(past.dtype)],
                             dim=1)                              # (B, K, C)
        co = conv_step(conv_win, conv_w, conv_b)                 # (B, C)
        xc, Bc, Cc = torch.split(co, [dl, N, N], dim=-1)
        xh = xc.reshape(B, Hl, hd).float()
        Bt, Ct = Bc.float(), Cc.float()                          # (B, N)
        dt1 = dt[:, 0]                                           # (B, H)
        a = torch.exp(dt1 * A[None, :])
        h_new = (a[:, :, None, None] * cache["h"] +
                 dt1[:, :, None, None] * Bt[:, None, :, None]
                 * xh[:, :, None, :])
        y = torch.einsum("bn,bhnd->bhd", Ct, h_new)
        y = (y + D[None, :, None] * xh)[:, None]                 # (B,1,H,hd)
        cache["h"].copy_(h_new)
        cache["conv"].copy_(torch.cat(
            [cache["conv"], conv_cache(conv_in).to(cache["conv"].dtype)],
            dim=1)[:, 1:] if split else conv_win[:, 1:])

    y = y.reshape(B, S, dl).to(ct)
    y = rms_norm({"scale": params["norm"]}, y, cfg.norm_eps, cols=x_cols)
    y = y * F.silu(z)
    if rows is not None:
        y = C.data_gather(y, 0, rows[4])
    w_out = params["out_proj"].to(ct)
    if split or not mc.splits(spec["out_proj"], 0):
        y = y @ w_out
        return (C.tp_reduce(y, mc) if split else y), cache
    # heads replicated, out_proj sharded over ``inner``: row-parallel on
    # the rank's rows of it
    lo, hi = mc.shard(spec["out_proj"], 0)
    return C.tp_reduce(C.tp_copy(y, mc)[..., lo:hi] @ w_out, mc), cache


def _ssd_chunked(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, A: torch.Tensor, *, chunk: int,
                 h0: Optional[torch.Tensor] = None):
    """Chunked SSD: x (B,S,H,hd), Bm/Cm (B,S,N), dt (B,S,H), A (H,).

    Per chunk of length L:
      intra: y[t] += sum_{s<=t} exp(lam_t - lam_s) dt_s (C_t.B_s) x_s
      inter: y[t] += exp(lam_t) C_t . Hprev ;
             Hnew = exp(lam_L) Hprev + sum_s exp(lam_L - lam_s) dt_s B_s x_s^T

    S must be a multiple of ``min(chunk, S)``, as in the reference (a
    prompt longer than a chunk and not a multiple of it fails there too).
    """
    B, S, H, hd = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    assert S % L == 0, (S, L)
    dev = x.device
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))

    h = (torch.zeros((B, H, N, hd), dtype=torch.float32, device=dev)
         if h0 is None else h0)
    ys = []
    for c0 in range(0, S, L):
        xk, bk, ck = x[:, c0:c0 + L], Bm[:, c0:c0 + L], Cm[:, c0:c0 + L]
        dtk = dt[:, c0:c0 + L]                                   # (B,L,H)
        lam = torch.cumsum(dtk * A[None, None, :], dim=1)        # (B,L,H)
        # intra-chunk quadratic term.  The upper triangle's decay is
        # positive and its exp overflows to inf past ~88 (a long chunk), so
        # it is masked to -inf *before* the exp: the backward then
        # multiplies zeros by zeros, where a select after the exp would
        # give 0 * inf = NaN
        cb = torch.einsum("bln,bmn->blm", ck, bk)                # (B,L,L)
        decay = lam[:, :, None, :] - lam[:, None, :, :]          # (B,L,L,H)
        decay = decay.masked_fill(~mask[None, :, :, None], float("-inf"))
        M = torch.exp(decay) * cb[..., None] * dtk[:, None, :, :]
        y = torch.einsum("blsh,bshd->blhd", M, xk)
        # inter-chunk: contribution of the carried state
        y = y + torch.exp(lam)[..., None] * torch.einsum(
            "bln,bhnd->blhd", ck, h)
        # state update
        lam_L = lam[:, -1:, :]                                   # (B,1,H)
        w = torch.exp(lam_L - lam) * dtk                         # (B,L,H)
        h = (torch.exp(lam_L)[:, 0, :, None, None] * h +
             torch.einsum("blh,bln,blhd->bhnd", w, bk, xk))
        ys.append(y)
    return torch.cat(ys, dim=1), h


__all__ = ["mamba_spec", "mamba_apply", "init_mamba_cache", "causal_conv",
           "conv_step"]
