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
(flash-decoding): each block lists its split's valid slots, streams their
codes through a ring in shared memory (``cp.async``), rescales once a tile
and writes a partial ``(m, l, acc)`` to float32 scratch allocated here; the
last split of each head to finish merges them (a row with no valid slot
gets the mean of V) and writes each row's log-sum-exp beside its output,
so that the results over disjoint slot ranges (a cache whose sequence is
sharded over ranks) merge exactly: :func:`merge_partials`.  ``S`` need not be a multiple of anything
(the reference wrapper padded to its chunk); the launch shape, the number of
splits included, is chosen in :func:`~repro_torch.kernels._common.
decode_attention_launch`.  Bound on an H100: bytes (the codes and scales of
the valid slots, read once); see the source's header.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import build as _build
from ._common import (INT32_MAX, check_contiguous, check_current_device,
                      check_same_device, current_stream_ptr,
                      decode_attention_launch)

NEG_INF = -1e30

#: per CUDA device, the kernel's split counters: one int32 per (sequence, kv
#: head, tile of query rows) of a launch, 0 between launches (the last split
#: of each sets its count back), so launches on one stream share them
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


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
                                softcap: float = 0.0,
                                return_lse: bool = False):
    """Plain PyTorch version: dequantize the whole cache to float32, then the
    masked max/exp/sum attention — ``ref.py:decode_attention_int8_ref``, with
    the scores capped at ``softcap * tanh(s / softcap)`` before the mask
    when ``softcap > 0`` (``models/attention.py:decode_attention``).  With
    ``return_lse``: ``(out, lse)``, as :func:`decode_attention_int8`."""
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
    if not return_lse:
        return out.to(q.dtype)
    return out.to(q.dtype), row_lse(m[..., 0], l[..., 0])


def row_lse(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """A row's natural-log log-sum-exp ``m + log l`` from its largest score
    ``m`` and its sum ``l`` of ``exp(s - m)``; ``NEG_INF`` itself for a row
    with no valid slot (``m == NEG_INF``), the same on every rank."""
    return torch.where(m <= NEG_INF, torch.full_like(m, NEG_INF),
                       m + torch.log(l))


def merge_partials(outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
    """The attention over the union of disjoint slot ranges from each
    range's ``(out, lse)``: weights ``exp(lse - max lse)``, the outputs'
    weighted sum over the weights' sum, in float32, cast once to the
    outputs' dtype.  A range with no valid slot (``lse = NEG_INF``) weighs
    0 beside one that has one; where no range has one, every range weighs
    1 (each range's mean of V: the mean over equal ranges)."""
    lse = torch.stack([t.float() for t in lses])
    w = torch.exp(lse - lse.amax(dim=0))
    num = (torch.stack([o.float() for o in outs]) * w[..., None]).sum(dim=0)
    return (num / w.sum(dim=0)[..., None]).to(outs[0].dtype)


def decode_attention_int8(q: torch.Tensor, k_q: torch.Tensor,
                          k_s: torch.Tensor, v_q: torch.Tensor,
                          v_s: torch.Tensor, key_pos: torch.Tensor,
                          q_pos: torch.Tensor, *,
                          window: Optional[int] = None,
                          softcap: float = 0.0, return_lse: bool = False
                          ) -> Union[torch.Tensor,
                                     Tuple[torch.Tensor, torch.Tensor]]:
    """q ``(B, KV, G, Dh)`` -> out ``(B, KV, G, Dh)`` in q's dtype; with
    ``return_lse``, ``(out, lse)``: ``lse`` ``(B, KV, G)`` float32, each
    row's natural-log log-sum-exp of its masked, capped scores (``-1e30``
    for a row with no valid slot), so that results over disjoint slot
    ranges merge (:func:`merge_partials`).  The kernel writes both either
    way.

    ``k_q``/``v_q`` ``(B, S, KV, Dh)`` int8; ``k_s``/``v_s`` ``(B, S, KV)``
    scales; ``key_pos`` ``(B, S)`` int32 absolute positions (-1 empty);
    ``q_pos`` ``(B,)`` int32; ``softcap > 0`` caps each score at
    ``softcap * tanh(s / softcap)`` before the mask.  CPU tensors run
    :func:`decode_attention_int8_plain`; CUDA tensors launch the kernel (which
    takes bfloat16 scales — the cache layout of ``models/attention.py`` — and
    heads of a multiple of 16) or raise.

    The call goes through the custom operator
    ``torch.ops.repro_torch.decode_attention_int8`` (a CPU and a CUDA
    implementation, a fake one that gives the output's shape and dtype, and
    a FLOP formula), so a trace on fake tensors (``launch/dryrun.py``)
    counts this kernel on either device and launches nothing."""
    _check(q, k_q, k_s, v_q, v_s, key_pos, q_pos)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention_int8 takes CPU or CUDA tensors; "
                         f"got {q.device}")
    out, lse = _op(q, k_q, k_s, v_q, v_s, key_pos, q_pos, window, softcap)
    return (out, lse) if return_lse else out


def _launch(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
            v_q: torch.Tensor, v_s: torch.Tensor, key_pos: torch.Tensor,
            q_pos: torch.Tensor, window: Optional[int],
            softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on checked CUDA operands (one launch, counted):
    ``(out, lse)``."""
    B, S, KV, Dh = k_q.shape
    G = q.shape[2]
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
    lse = torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
    counters = _counters(q.device, B * KV * -(-G // g_tile))
    has_window = window is not None
    scale = float(np.float32(1.0) / np.sqrt(np.float32(Dh)))
    code = _build.launcher("decode_attention_int8")(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), key_pos.data_ptr(), q_pos.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), lse.data_ptr(), counters.data_ptr(), B, S, KV, G, Dh,
        lanes, threads,
        g_tile,
        keys_per_split, splits,
        min(max(int(window), -INT32_MAX), INT32_MAX) if has_window else 0,
        int(has_window), scale, float(max(softcap, 0.0)),
        int(q.dtype == torch.bfloat16),
        current_stream_ptr())
    _build.check_launch("decode_attention_int8", code)
    decode_attention_int8.launches += 1
    return out, lse


@torch.library.custom_op("repro_torch::decode_attention_int8",
                         mutates_args=(), device_types="cuda")
def _op(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
        v_q: torch.Tensor, v_s: torch.Tensor, key_pos: torch.Tensor,
        q_pos: torch.Tensor, window: Optional[int],
        softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(q, k_q, k_s, v_q, v_s, key_pos, q_pos, window, softcap)


@_op.register_kernel("cpu")
def _op_cpu(q, k_q, k_s, v_q, v_s, key_pos, q_pos, window, softcap):
    return decode_attention_int8_plain(q, k_q, k_s, v_q, v_s, key_pos, q_pos,
                                       window, softcap, return_lse=True)


@_op.register_fake
def _op_fake(q, k_q, k_s, v_q, v_s, key_pos, q_pos, window, softcap):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


def decode_attention_flops(q_shape, k_q_shape, *args, **kwargs) -> int:
    """FLOPs of one call counted over every cache slot (``4 KV G Dh`` a
    slot and sequence: ``q . k`` and ``p v``): the arithmetic of the
    ``kernels`` phase's bound in ``chip_smoke.py`` with every slot valid —
    a trace has shapes, not the positions that mask slots out."""
    B, S, KV, Dh = k_q_shape
    return 4 * B * KV * q_shape[2] * Dh * S


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula
    register_flop_formula(torch.ops.repro_torch.decode_attention_int8)(
        decode_attention_flops)


_register_flops()


#: number of kernel launches made by :func:`decode_attention_int8` in this
#: process
decode_attention_int8.launches = 0

__all__ = ["decode_attention_int8", "decode_attention_int8_plain",
           "decode_attention_flops", "merge_partials", "row_lse"]
