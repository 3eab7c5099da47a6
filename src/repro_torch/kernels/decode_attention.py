"""Fused int8-KV decode attention — a hand-written CUDA kernel
(``csrc/decode_attention_int8.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:
decode_attention_int8`` (``_kernel``): one query token per sequence against a
KV cache of int8 codes with per-(slot, kv head) scales, dequantized inside
the kernel so that no float copy of the cache is written to device memory —
the copy the int8 decode branch of ``models/attention.py`` would otherwise
make before a plain masked softmax.  Semantics are those of the reference's
oracle ``repro/kernels/ref.py:decode_attention_int8_ref``, with the logit
softcap of ``models/attention.py:decode_attention`` (the int8 decode branch of
the reference dequantizes and calls it): masked slots
score -1e30 (a row with no valid slot gives the mean of V, never NaN), the
online softmax runs in float32 and the output is cast to q's dtype.

The TPU kernel walked the sequence in order, carrying ``(m, l, acc)`` across
chunks.  Hopper blocks share no state, so the kernel splits the sequence
(flash-decoding): each block writes a partial ``(m, l, acc)`` of its split
to float32 scratch allocated here, and a second kernel of the same source
merges the splits.  ``S`` need not be a multiple of anything (the reference
wrapper padded to its chunk); the launch shape, the number of splits
included, is chosen in :func:`~repro_torch.kernels._common.
decode_attention_launch`.  Bound on an H100: bytes (the codes and scales of
the cache, read once); see the source's header.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import build as _build
from ._common import (INT32_MAX, check_contiguous, check_current_device,
                      check_same_device, current_stream_ptr,
                      decode_attention_launch)

NEG_INF = -1e30


def _check(q, k_q, k_s, v_q, v_s, key_pos, q_pos):
    """Check the operands; returns ``(B, S, KV, G, Dh)``."""
    if q.dtype not in (torch.float32, torch.bfloat16) or q.ndim != 4:
        raise TypeError(f"q must be a (B, KV, G, Dh) float32 or bfloat16 "
                        f"tensor; got {q.dtype} {tuple(q.shape)}")
    B, KV, G, Dh = q.shape
    if k_q.ndim != 4:
        raise ValueError(f"k_q must be (B, S, KV, Dh); got "
                         f"{tuple(k_q.shape)}")
    S = k_q.shape[1]
    for name, t in (("k_q", k_q), ("v_q", v_q)):
        if t.dtype != torch.int8 or tuple(t.shape) != (B, S, KV, Dh):
            raise TypeError(f"{name} must be int8 of shape {(B, S, KV, Dh)}; "
                            f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("k_s", k_s), ("v_s", v_s)):
        if not t.is_floating_point() or tuple(t.shape) != (B, S, KV):
            raise TypeError(f"{name} must be a float tensor of shape "
                            f"{(B, S, KV)}; got {t.dtype} {tuple(t.shape)}")
    if key_pos.dtype != torch.int32 or tuple(key_pos.shape) != (B, S):
        raise TypeError(f"key_pos must be int32 of shape {(B, S)}; got "
                        f"{key_pos.dtype} {tuple(key_pos.shape)}")
    if q_pos.dtype != torch.int32 or tuple(q_pos.shape) != (B,):
        raise TypeError(f"q_pos must be int32 of shape {(B,)}; got "
                        f"{q_pos.dtype} {tuple(q_pos.shape)}")
    if S < 1:
        raise ValueError("decode attention needs at least one cache slot")
    check_same_device(q, k_q=k_q, k_s=k_s, v_q=v_q, v_s=v_s,
                      key_pos=key_pos, q_pos=q_pos)
    return B, S, KV, G, Dh


def decode_attention_int8_plain(q: torch.Tensor, k_q: torch.Tensor,
                                k_s: torch.Tensor, v_q: torch.Tensor,
                                v_s: torch.Tensor, key_pos: torch.Tensor,
                                q_pos: torch.Tensor,
                                window: Optional[int] = None,
                                softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: dequantize the whole cache to float32, then the
    masked max/exp/sum attention — ``ref.py:decode_attention_int8_ref``, with
    the scores capped at ``softcap * tanh(s / softcap)`` before the mask
    when ``softcap > 0`` (``models/attention.py:decode_attention``)."""
    kf = k_q.float() * k_s.float()[..., None]
    vf = v_q.float() * v_s.float()[..., None]
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32,
                                          device=q.device))
    s = torch.einsum("bkgd,bskd->bkgs", q.float() * scale, kf)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = (key_pos >= 0) & (key_pos <= q_pos[:, None])
    if window is not None:
        valid &= key_pos > (q_pos[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / l.clamp_min(1e-30), vf)
    return out.to(q.dtype)


def decode_attention_int8(q: torch.Tensor, k_q: torch.Tensor,
                          k_s: torch.Tensor, v_q: torch.Tensor,
                          v_s: torch.Tensor, key_pos: torch.Tensor,
                          q_pos: torch.Tensor, *,
                          window: Optional[int] = None,
                          softcap: float = 0.0) -> torch.Tensor:
    """q ``(B, KV, G, Dh)`` -> out ``(B, KV, G, Dh)`` in q's dtype.

    ``k_q``/``v_q`` ``(B, S, KV, Dh)`` int8; ``k_s``/``v_s`` ``(B, S, KV)``
    scales; ``key_pos`` ``(B, S)`` int32 absolute positions (-1 empty);
    ``q_pos`` ``(B,)`` int32; ``softcap > 0`` caps each score at
    ``softcap * tanh(s / softcap)`` before the mask.  CPU tensors run
    :func:`decode_attention_int8_plain`; CUDA tensors launch the kernel (which
    takes bfloat16 scales — the cache layout of ``models/attention.py`` — and
    heads of a multiple of 16) or raise."""
    B, S, KV, G, Dh = _check(q, k_q, k_s, v_q, v_s, key_pos, q_pos)
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k_q, k_s, v_q, v_s, key_pos,
                                           q_pos, window, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8 takes CPU or CUDA tensors; "
                         f"got {q.device}")
    check_current_device(q)
    check_contiguous(q=q, k_q=k_q, k_s=k_s, v_q=v_q, v_s=v_s,
                     key_pos=key_pos, q_pos=q_pos)
    if k_s.dtype != torch.bfloat16 or v_s.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16 scales; got {k_s.dtype}, "
                        f"{v_s.dtype}")
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("k_q and v_q must start on a 16-byte boundary")
    lanes, threads, g_tile, keys_per_split, splits = decode_attention_launch(
        B, KV, G, S, Dh,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    part_m = torch.empty((B, KV, G, splits), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, KV, G, splits, Dh), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    has_window = window is not None
    scale = float(np.float32(1.0) / np.sqrt(np.float32(Dh)))
    code = _build.launcher("decode_attention_int8")(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), key_pos.data_ptr(), q_pos.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), B, S, KV, G, Dh, lanes, threads, g_tile,
        keys_per_split, splits,
        min(max(int(window), -INT32_MAX), INT32_MAX) if has_window else 0,
        int(has_window), scale, float(max(softcap, 0.0)),
        int(q.dtype == torch.bfloat16),
        current_stream_ptr())
    _build.check_launch("decode_attention_int8", code)
    decode_attention_int8.launches += 1
    return out


#: number of kernel launches made by :func:`decode_attention_int8` in this
#: process
decode_attention_int8.launches = 0

__all__ = ["decode_attention_int8", "decode_attention_int8_plain"]
