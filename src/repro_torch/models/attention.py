"""Attention: GQA/MHA with RoPE, optional qk-norm, sliding window, logit
softcap; blockwise (flash-style) online-softmax for train/prefill so long
score matrices never materialize; KV-cache decode with a masked softmax.

The port of the JAX package's ``models/attention.py``: the same functions,
shapes (``wq (d, h, hd)``, ``wo (h, hd, d)``, caches ``(B, slots, KV, hd)``)
and masks.  :func:`flash_attention` stays plain PyTorch with the reference's
chunked online softmax (not ``scaled_dot_product_attention``: softcap,
window and ``q_offset`` must mean what they mean there).  The int8 decode
branch of :func:`attention_apply` launches the fused kernel
:func:`~repro_torch.kernels.decode_attention.decode_attention_int8` (K11)
where the reference dequantizes the whole cache to float32 and runs
:func:`decode_attention`; the non-quantized decode branch keeps the plain
:func:`decode_attention`, as the reference does.

On a mesh (``sharding/rules.py:mesh_context``) ``wq``/``wk``/``wv`` are
the rank's ``model`` shards over heads and KV heads (column-parallel),
``wo`` over heads (row-parallel, a sum over ``model``), and a cache holds
the rank's KV heads: every path runs on the local heads, K11 among them.
KV heads that do not divide the axis (a config not resolved for it:
``ModelConfig.resolve_for_tp``) stay replicated: each rank computes and
caches all of them and its query heads read their groups' ones.
Sequence-parallel (``MeshContext.seq_split``) the block's input is the
rank's shard of the sequence, gathered before the projections, and ``wo``'s
partial sums are reduce-scattered back over it.  Weight-stationary
(``MeshContext.ws``) the projections contract the rank's columns of ``d``
(q/k/v summed over the FSDP axes, so every rank holds them whole) and
``wo`` gives them; a decode step then reads the cache the rank holds
(``MeshContext.span``): its batch rows (the rank's rows of q, its output
gathered over the FSDP axes before ``wo``) or its range of slots (context
parallelism: the rank writes a new position only into a slot of its
range, K11 returns each row's log-sum-exp beside its output, and the
partial softmaxes merge over the ranks: ``collectives.lse_merge``).

Windowed ("local") layers use a *ring-buffer* KV cache of exactly
``window`` slots.  Caches are plain dicts of tensors, **updated in place**
(indexed stores) where the reference returns updated copies;
:func:`attention_apply` returns the same dict it was given."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..kernels.decode_attention import decode_attention_int8, row_lse
from ..sharding import collectives as C
from ..sharding.rules import ParamSpec, mesh_context
from .layers import NEG_INF, apply_rope, data_products, rms_norm


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def attention_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.eff_heads, cfg.eff_kv_heads, cfg.head_dim
    spec = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm:
        spec["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        spec["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return spec


def _inv_sqrt(dh: int, device) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(dh, dtype=torch.float32,
                                         device=device))


# ---------------------------------------------------------------------------
# blockwise (flash) attention for train/prefill
# ---------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset=0, window: Optional[int] = None,
                    softcap: float = 0.0, kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention.

    q: (B, Sq, KV, G, Dh) — query heads grouped by kv head;
    k, v: (B, Sk, KV, Dh).  Returns (B, Sq, KV, G, Dh).
    The kv axis is walked in ``kv_chunk`` blocks carrying (m, l, acc)."""
    B, Sq, KV, G, Dh = q.shape
    Sk = k.shape[1]
    kv_chunk = min(kv_chunk, Sk)
    assert Sk % kv_chunk == 0, (Sk, kv_chunk)
    dev = q.device
    q32 = q.float() * _inv_sqrt(Dh, dev)
    q_pos = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, Dh), dtype=torch.float32, device=dev)
    for c0 in range(0, Sk, kv_chunk):
        kc = k[:, c0:c0 + kv_chunk].float()
        vc = v[:, c0:c0 + kv_chunk].float()
        s = torch.einsum("bqkgd,bskd->bqkgs", q32, kc)
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        k_pos = c0 + torch.arange(kv_chunk, device=dev)
        mask = q_pos[:, None] >= k_pos[None, :]      # causal (Sq, kv_chunk)
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgs,bskd->bqkgd", p,
                                                    vc)
        m = m_cur
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def flash_attention_swa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int, softcap: float = 0.0,
                        q_chunk: int = 1024) -> torch.Tensor:
    """Banded flash attention for sliding-window layers: the query axis in
    ``q_chunk`` blocks, each against the ``window + q_chunk`` keys it can
    see.  q: (B, Sq, KV, G, Dh); k, v: (B, Sk, KV, Dh); Sq == Sk."""
    B, Sq, KV, G, Dh = q.shape
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    assert Sq % q_chunk == 0, (Sq, q_chunk)
    band = min(window + q_chunk, Sk)
    outs = []
    for q_start in range(0, Sq, q_chunk):
        k_start = min(max(q_start + q_chunk - band, 0), Sk - band)
        # flash masks causality/window from absolute positions via q_offset
        outs.append(flash_attention(
            q[:, q_start:q_start + q_chunk], k[:, k_start:k_start + band],
            v[:, k_start:k_start + band], q_offset=q_start - k_start,
            window=window, softcap=softcap, kv_chunk=band))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# decode attention over a KV cache (full or ring)
# ---------------------------------------------------------------------------
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, key_pos: torch.Tensor,
                     q_pos: torch.Tensor, *, window: Optional[int] = None,
                     softcap: float = 0.0, return_lse: bool = False):
    """q: (B, 1, KV, G, Dh); caches: (B, Smax, KV, Dh).

    ``key_pos`` (B, Smax) gives the absolute position stored in each cache
    slot (-1 = empty) — uniform treatment of linear and ring caches and of
    per-sequence lengths (continuous batching).  ``q_pos``: (B,).  With
    ``return_lse``: ``(out, lse)``, ``lse`` (B, 1, KV, G) float32 each
    row's log-sum-exp (K11's, ``kernels/decode_attention.py``)."""
    Dh = q.shape[-1]
    q32 = q[:, 0].float() * _inv_sqrt(Dh, q.device)       # (B, KV, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", q32, k_cache.float())
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = (key_pos >= 0) & (key_pos <= q_pos[:, None])
    if window is not None:
        valid &= key_pos > (q_pos[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / l.clamp_min(1e-30),
                       v_cache.float())
    out = out[:, None].to(q.dtype)                        # (B, 1, KV, G, Dh)
    if not return_lse:
        return out
    return out, row_lse(m[..., 0], l[..., 0])[:, None]


# ---------------------------------------------------------------------------
# KV cache construction
# ---------------------------------------------------------------------------
def kv_cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    """Ring caches for windowed layers: bounded at the window size."""
    if kind in ("local", "local_moe") and cfg.window:
        return min(cfg.window, max_len)
    return max_len


def init_kv_cache(cfg: ModelConfig, batch: int, slots: int, dtype,
                  quant: Optional[bool] = None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """quant=True: int8 cache with per-(token, head) bfloat16 scales — the
    production serving layout (halves KV bytes)."""
    kv, hd = cfg.eff_kv_heads, cfg.head_dim
    quant = cfg.kv_quant if quant is None else quant
    dev = resolve_device(device)
    if quant:
        return {
            "k": torch.zeros((batch, slots, kv, hd), dtype=torch.int8,
                             device=dev),
            "k_s": torch.zeros((batch, slots, kv), dtype=torch.bfloat16,
                               device=dev),
            "v": torch.zeros((batch, slots, kv, hd), dtype=torch.int8,
                             device=dev),
            "v_s": torch.zeros((batch, slots, kv), dtype=torch.bfloat16,
                               device=dev),
        }
    return {
        "k": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=dev),
        "v": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=dev),
    }


def _quantize_kv(x: torch.Tensor):
    """x (..., hd) -> (int8 codes, bfloat16 scales (...)); ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-6) / 127.0
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None].float()


# ---------------------------------------------------------------------------
# attention block apply (projections + rope + attn + out)
# ---------------------------------------------------------------------------
def _prefill_attention(qg, k, v, cfg: ModelConfig, window: Optional[int]):
    S = qg.shape[1]
    if cfg.swa_banded and window is not None and \
            window + cfg.flash_kv_chunk < S:
        # banded path: skip fully-masked chunks
        return flash_attention_swa(qg, k, v, window=window,
                                   softcap=cfg.attn_logit_softcap,
                                   q_chunk=cfg.flash_kv_chunk)
    return flash_attention(qg, k, v, window=window,
                           softcap=cfg.attn_logit_softcap,
                           kv_chunk=cfg.flash_kv_chunk)


def _heads(kv: slice, held: int, *ts: torch.Tensor):
    """Each of ``ts`` (..., held KV heads, Dh) at the KV heads ``kv``."""
    if kv.stop - kv.start == held:
        return ts
    return tuple(t[:, :, kv] for t in ts)


def _local_writes(positions: int, total: int, start: int, stop: int):
    """``(local slots, positions)`` of a prefill of ``positions`` tokens
    into the slots ``start:stop`` of a cache of ``total`` slots (a ring
    when ``total < positions``): slot ``j`` holds the last position ``p``
    with ``p % total == j``; python lists, no device work."""
    out = [(j - start, positions - 1 - ((positions - 1 - j) % total))
           for j in range(start, stop)]
    out = [(j, p) for j, p in out if p >= 0]
    return [j for j, _ in out], [p for _, p in out]


def attention_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                    window: Optional[int] = None,
                    rope_theta: Optional[float] = None,
                    cache: Optional[Dict[str, Any]] = None,
                    cache_len=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d).

    * cache is None             -> train/prefill-no-cache (flash path);
    * cache given, S == 1       -> single-token decode at position cache_len
      (an int, or a (B,) tensor of per-sequence lengths);
    * cache given, S > 1        -> prefill-and-fill-cache (fresh sequence).
    Ring caches (slots == window < needed length) are handled transparently.
    A given cache is written in place and returned.  On a mesh see the
    module docstring.
    """
    ct = cfg.compute_dtype
    mc = mesh_context()
    # the rank's query heads and the KV heads it holds (all of them off a
    # mesh); ``kv`` the held KV heads its query heads read, in groups of G
    spec = attention_spec(cfg)
    h0, h1 = mc.shard(spec["wq"], 1)
    k0, k1 = mc.shard(spec["wk"], 1)
    H, KVh = h1 - h0, k1 - k0
    split, kv_split = H != cfg.eff_heads, KVh != cfg.eff_kv_heads
    if split and not kv_split:                # KV heads replicated
        kv = slice(h0 // cfg.q_per_kv, (h1 - 1) // cfg.q_per_kv + 1)
    else:
        kv = slice(0, KVh)
    KV = kv.stop - kv.start
    G = H // KV
    if H != KV * G or (split and G != min(cfg.q_per_kv, H)):
        raise ValueError(
            f"query heads {h0}-{h1 - 1} of {cfg.eff_heads} on a rank of a "
            f"model axis of {mc.tp} do not read whole groups of the "
            f"{cfg.eff_kv_heads} KV heads: resolve the config for the "
            f"axis (ModelConfig.resolve_for_tp)")
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    dev = x.device
    if mc.seq_split:
        # the sequence's shards gathered; KV heads replicated: their
        # gradient (summed over model below) counted once
        if not split:
            raise ValueError("sequence parallelism needs the attention's "
                             f"heads split over the model axis of {mc.tp}")
        xq = C.seq_gather(x, mc)
        xk = xq if kv_split else C.tp_grad_once(xq, mc)
    else:
        xq = C.tp_copy(x, mc) if split else x
        # KV heads sharded like the query heads: column-parallel too; KV
        # heads replicated: every one computed (and cached) on each rank,
        # whose query heads read some of them
        xk = xq if kv_split else x
    B, S, _ = xq.shape
    Dh = cfg.head_dim

    if xk is xq:
        q, k, v = data_products(xq, params["wq"].to(ct).reshape(-1, H * Dh),
                                params["wk"].to(ct).reshape(-1, KVh * Dh),
                                params["wv"].to(ct).reshape(-1, KVh * Dh))
    else:
        q = data_products(xq, params["wq"].to(ct).reshape(-1, H * Dh))[0]
        k, v = data_products(xk, params["wk"].to(ct).reshape(-1, KVh * Dh),
                             params["wv"].to(ct).reshape(-1, KVh * Dh))
    q, k, v = (q.view(B, S, H, Dh), k.view(B, S, KVh, Dh),
               v.view(B, S, KVh, Dh))
    if cfg.qk_norm:
        # the scales are replicated and read by the rank's heads only
        qn, kn = params["q_norm"], params["k_norm"]
        if split:
            qn = C.tp_copy(qn, mc)
            kn = C.tp_copy(kn, mc) if kv_split else kn
        q = rms_norm({"scale": qn}, q, cfg.norm_eps)
        k = rms_norm({"scale": kn}, k, cfg.norm_eps)
    if split and not kv_split:
        k, v = C.tp_copy(k, mc), C.tp_copy(v, mc)

    if cache is None:
        positions = torch.arange(S, device=dev)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
        out = _prefill_attention(q.reshape(B, S, KV, G, Dh), *_heads(
            kv, KVh, k, v), cfg, window)
    elif S == 1:
        out = _decode(q, k, v, cache, cache_len, cfg, kv, KVh, KV, G,
                      window, theta)
    else:
        # prefill a fresh sequence AND fill the cache with the last `slots`
        quant = "k_s" in cache
        positions = torch.arange(S, device=dev)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
        out = _prefill_attention(q.reshape(B, S, KV, G, Dh), *_heads(
            kv, KVh, k, v), cfg, window)
        if quant:
            k_w, k_sw = _quantize_kv(k)       # (B,S,KV,hd), (B,S,KV)
            v_w, v_sw = _quantize_kv(v)
            writes = {"k": k_w, "k_s": k_sw, "v": v_w, "v_s": v_sw}
        else:
            writes = {"k": k, "v": v}
        span = mc.span(cache["k"])
        if span is not None and span[0] == 0:     # the rank's batch rows
            writes = {n: t[span[1]:span[2]] for n, t in writes.items()}
        slots = cache["k"].shape[1]
        for name, val in writes.items():
            if span is not None and span[0] == 1:  # the rank's slots
                js, ps = _local_writes(S, span[3], span[1], span[2])
                if js:
                    cache[name][:, js] = val[:, ps].to(cache[name].dtype)
            elif slots >= S:
                cache[name][:, :S] = val.to(cache[name].dtype)
            else:  # ring: keep the last `slots` positions at ring slots
                ring_slots = positions[S - slots:] % slots
                cache[name][:, ring_slots] = \
                    val[:, S - slots:].to(cache[name].dtype)

    out = out.reshape(B, S, H * Dh)
    y = out @ params["wo"].to(ct).reshape(H * Dh, -1)
    if mc.seq_split:
        return C.seq_scatter(y, mc), cache
    return (C.tp_reduce(y, mc) if split else y), cache


def _decode(q, k, v, cache, cache_len, cfg: ModelConfig, kv: slice,
            KVh: int, KV: int, G: int, window: Optional[int], theta):
    """One token's attention against the cache the rank holds (its batch
    rows or its range of slots: ``MeshContext.span``), the new key and
    value written first; ``(B, 1, KV, G, Dh)`` for every row of ``q``."""
    mc = mesh_context()
    B, Dh = q.shape[0], q.shape[-1]
    dev = q.device
    quant = "k_s" in cache
    pos_b = torch.as_tensor(cache_len, dtype=torch.int32,
                            device=dev).broadcast_to((B,)).contiguous()
    q = apply_rope(q, pos_b[:, None], theta)
    k = apply_rope(k, pos_b[:, None], theta)
    span = mc.span(cache["k"])
    rows = span if span is not None and span[0] == 0 else None
    cp = span if span is not None and span[0] == 1 else None
    if rows is not None:                     # the rank's batch rows
        lo, hi = rows[1:3]
        q, k, v, pos_b = q[lo:hi], k[lo:hi], v[lo:hi], pos_b[lo:hi]
    Bl = q.shape[0]
    slots = cache["k"].shape[1]
    total, first = (cp[3], cp[1]) if cp is not None else (slots, 0)
    slot_b = (pos_b % total).long()                   # ring-aware write
    bidx = torch.arange(Bl, device=dev)
    if quant:
        kq, ks = _quantize_kv(k[:, 0])
        vq, vs = _quantize_kv(v[:, 0])
        writes = {"k": kq, "k_s": ks, "v": vq, "v_s": vs}
    else:
        writes = {"k": k[:, 0], "v": v[:, 0]}
    if cp is None:
        for name, val in writes.items():
            cache[name][bidx, slot_b] = val.to(cache[name].dtype)
    else:
        # only the rank whose range holds the slot writes it (elsewhere
        # the slot written is rewritten with what it held)
        mine = (slot_b >= first) & (slot_b < first + slots)
        at = (slot_b - first).clamp(0, slots - 1)
        for name, val in writes.items():
            keep = mine.view((Bl,) + (1,) * (val.dim() - 1))
            cache[name][bidx, at] = torch.where(
                keep, val.to(cache[name].dtype), cache[name][bidx, at])
    # absolute position held by each slot after the write
    idx = torch.arange(first, first + slots, device=dev, dtype=torch.int32)
    key_pos = pos_b[:, None] - ((pos_b[:, None] - idx[None, :]) % total)
    read = cache if KV == KVh else {
        n: c[:, :, kv].contiguous() for n, c in cache.items()}
    # context parallelism: q widened to float32 (the same scores), so the
    # partial outputs are merged in float32 and rounded once
    qk = q if cp is None else q.float()
    if quant:
        out = decode_attention_int8(
            qk.reshape(Bl, KV, G, Dh), read["k"], read["k_s"], read["v"],
            read["v_s"], key_pos, pos_b, window=window,
            softcap=cfg.attn_logit_softcap, return_lse=cp is not None)
    else:
        out = decode_attention(qk.reshape(Bl, 1, KV, G, Dh), read["k"],
                               read["v"], key_pos, pos_b, window=window,
                               softcap=cfg.attn_logit_softcap,
                               return_lse=cp is not None)
    if cp is not None:
        out = C.lse_merge(*out, cp[4]).to(q.dtype)
    if rows is not None:
        out = C.data_gather(out, 0, rows[4])
    return out


__all__ = ["attention_spec", "attention_apply", "flash_attention",
           "flash_attention_swa", "decode_attention", "init_kv_cache",
           "kv_cache_len", "NEG_INF"]
