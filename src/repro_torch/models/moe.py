"""Mixture-of-Experts with an auto-tuned dispatch format — the paper's
technique inside the LM.

The port of the JAX package's ``models/moe.py``.  The token->expert dispatch
matrix is a sparse matrix: rows = experts, row length = tokens routed to that
expert.  Two dispatch layouts:

  * **ELL** (``moe_dispatch="ell"``, :func:`moe_ell`): fixed-capacity padded
    buffers (B, E, C, d) — constant row width, zero fill, overflow dropped —
    and dense einsums over every expert;
  * **CSR** (``moe_dispatch="csr"``, :func:`moe_csr`): dropless — tokens
    sorted by expert (the CSR row order), then one grouped product per expert
    over its row-pointer slice.  No drops, no padding, ragged work.

``moe_dispatch="auto"`` applies the paper's on-line rule per call: ``D_mat =
σ/μ`` of tokens per expert (:func:`dispatch_d_mat`); ``D_mat < D*`` -> ELL,
else CSR.

**Host syncs.**  The reference computes both choices on the device
(``lax.cond`` selects a branch, ``ragged_dot`` takes the group sizes as a
device array).  Eager PyTorch has neither, so two calls read a value back
from the device, once per MoE layer and call: ``"auto"`` reads ``D_mat`` to
run one branch only (never both), and :func:`moe_csr` reads the group sizes
to slice each expert's rows.  :func:`moe_ell` reads nothing back.

**On a mesh** (``sharding/rules.py:mesh_context``) the rules shard the
experts over ``model`` where their count divides it (expert parallelism:
a rank runs its own experts on every token of its batch shard, in both
layouts) and each expert's ``ffn`` dim where it does not (each SwiGLU
column- then row-parallel); either way the rank's output is a partial sum
added over ``model``, and no all-to-all is needed, the tokens being
replicated over ``model``.  The router's logits are gathered over
``model`` (its ``experts`` dim may be sharded), so every rank of a group
routes bitwise alike.  The router's statistics (the auxiliary loss's two
batch means, ``"auto"``'s counts) are the global batch's: summed over the
batch axes, over the real rows only where a microbatch was padded.

Sequence-parallel (``MeshContext.seq_split``) the block gathers the
sequence's shards first and reduce-scatters its partial sums back (the
gather's backward sums the partial input gradients, the router's among
them).  Weight-stationary
(``MeshContext.ws``) the tokens are the global batch, the router's logits
and each expert's gate and up products contract the rank's columns of
``d`` and are summed over the FSDP axes (every rank routes bitwise alike;
the counts are not summed over the batch, which is not split), and the
ELL buffers and the experts' outputs carry the rank's columns of ``d``.

Every function is plain PyTorch: the reference computes these products with
einsums and ``ragged_dot`` outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding import collectives as C
from ..sharding.rules import ParamSpec, mesh_context
from .layers import data_sums

# Default D* for the dispatch rule; overridable per call (learned off-line by
# :func:`learn_d_star` from the reference's benchmarks/moe_dispatch.py).
DEFAULT_D_STAR = 0.5


def moe_spec(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", "experts"), float32=True),
        "w_gate": ParamSpec((e, d, ff), ("experts", "embed", "ffn")),
        "w_up": ParamSpec((e, d, ff), ("experts", "embed", "ffn")),
        "w_down": ParamSpec((e, ff, d), ("experts", "ffn", "embed")),
    }


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
def route(params, x_flat: torch.Tensor, cfg: ModelConfig,
          real: Optional[torch.Tensor] = None):
    """x_flat: (T, d) -> (expert_ids (T, k) int64, gate_w (T, k), aux_loss).

    The router runs in float32 (its weight is stored in float32: its
    spec says ``float32``).  ``torch.topk`` does not promise the
    reference's tie order (lower index first); ties of float32 softmax
    probabilities do not occur on seeded inputs.

    On a mesh (see the module docstring) the logits of a router sharded
    over ``experts`` are gathered over ``model``, and the auxiliary loss's
    means run over the global batch (the batch axes' groups), over the
    tokens ``real`` (T,) marks when given."""
    mc = mesh_context()
    router = params["router"].float()
    x32 = x_flat.float()
    if mc.splits(moe_spec(cfg)["router"], 1):   # experts over ``model``
        # each rank's columns give a partial input gradient: summed here,
        # or by the sequence gather's backward where the sequence is split
        logits = C.tp_gather(C.data_sum(
            (x32 if mc.seq_split else C.tp_copy(x32, mc)) @ router, mc), -1,
            mc)
    else:
        if mc.seq_split:    # replicated: its input gradient counted once
            x32 = C.tp_grad_once(x32, mc)
        logits = C.data_sum(x32 @ router, mc)                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_ids = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance aux loss
    T, E = logits.shape
    w = (torch.ones(T, device=x_flat.device) if real is None
         else real.float())
    n = C.batch_sum(w.sum(), mc)                       # the global tokens
    me = C.batch_sum((probs * w[:, None]).sum(dim=0), mc) / n    # (E,)
    ce = C.batch_sum(torch.zeros(E, dtype=torch.float32,
                                 device=x_flat.device).index_add_(
        0, expert_ids.reshape(-1), w.repeat_interleave(cfg.top_k)),
        mc) / (n * cfg.top_k)
    aux = E * torch.sum(me * ce)
    return expert_ids, gate_w.to(x_flat.dtype), aux


def dispatch_d_mat(expert_ids: torch.Tensor, n_experts: int,
                   real: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paper's D_mat = σ/μ over tokens per expert (eq. 4); σ is the
    population deviation (``jnp.std``), hence ``correction=0``.

    On a mesh the counts are the global batch's (summed over the batch
    axes; the tokens ``real`` (T,) marks when given): whole numbers, so
    every rank reads the same ``D_mat`` bit for bit and every rank of a
    ``model`` group takes the same branch."""
    flat = expert_ids.reshape(-1)
    w = (torch.ones(flat.shape, device=flat.device) if real is None
         else real.float().repeat_interleave(flat.numel() // real.numel()))
    counts = C.batch_sum(torch.zeros(n_experts, dtype=torch.float32,
                                     device=flat.device).index_add_(
        0, flat, w), mesh_context())
    return counts.std(correction=0) / counts.mean().clamp_min(1e-9)


def learn_d_star(points, max_drop_frac: float = 0.05) -> float:
    """The paper's off-line step (4) applied to MoE dispatch.

    ``points``: iterable of (d_mat, t_ell, t_csr, ell_drop_frac).  ELL
    "qualifies" at a given imbalance when it is faster than CSR *and* its
    capacity drops stay within the quality budget; D* = max qualifying
    D_mat (0.0 if none)."""
    qual = [d for d, t_ell, t_csr, drop in points
            if t_ell < t_csr and drop <= max_drop_frac]
    return max(qual) if qual else 0.0


def _swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """One expert's SwiGLU over its rows ``x``; its gate and up products
    summed over the FSDP axes under ``ws`` (:func:`layers.data_sums`)."""
    g, u = data_sums(x @ w_gate, x @ w_up)
    return (F.silu(g) * u) @ w_down


# ---------------------------------------------------------------------------
# ELL (capacity) dispatch — per sequence (GShard group = sequence)
# ---------------------------------------------------------------------------
def capacity_of(cfg: ModelConfig, S: int, capacity: Optional[int] = None
                ) -> int:
    """Slots per expert and sequence: ``capacity_factor · S · k / E``, at
    least 1 (at decode the top-k experts are distinct, so C = 1 is exact) and
    at most ``S · k``."""
    k = cfg.top_k
    C = capacity or max(1, int(cfg.capacity_factor * S * k / cfg.n_experts))
    return min(C, S * k)


def moe_ell(params, x: torch.Tensor, expert_ids: torch.Tensor,
            gate_w: torch.Tensor, cfg: ModelConfig,
            capacity: Optional[int] = None) -> torch.Tensor:
    """Fixed-width buffers (B, E, C, d); overflow dropped — ELL semantics.

    A token's slot in its expert's row is its rank among the sequence's
    (token, choice) pairs routed there, in the flattened ``(S·k)`` order, so
    the same pairs are dropped as in the reference.  Pairs past capacity
    (the reference's scatter ``mode="drop"``) write to one extra slot that is
    cut off, and read zero back.  With the experts sharded over ``model``
    the buffers hold the rank's experts only (the others' pairs go to the
    extra slot too) and the output is the rank's part of the sum."""
    ct = x.dtype
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = capacity_of(cfg, S, capacity)
    dev = x.device
    e0, e1 = mesh_context().shard(moe_spec(cfg)["w_gate"], 0)

    flat_e = expert_ids.reshape(B, S * k)                       # (B, S*k)
    oh = F.one_hot(flat_e, E)                                   # (B, S*k, E)
    pos = torch.cumsum(oh, dim=1) - oh
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0]  # (B, S*k)
    in_cap = pos_in_e < cap
    if (e0, e1) != (0, E):
        in_cap &= (flat_e >= e0) & (flat_e < e1)
        flat_e = (flat_e - e0).clamp(0, e1 - e0 - 1)
    slot = torch.where(in_cap, pos_in_e, torch.full_like(pos_in_e, cap))
    x_rep = torch.repeat_interleave(x, k, dim=1)                # (B, S*k, d)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S * k)
    buf = torch.zeros((B, e1 - e0, cap + 1, d), dtype=ct, device=dev)
    buf.index_put_((bidx, flat_e, slot), x_rep)
    buf = buf[:, :, :cap]

    g, u = data_sums(
        torch.einsum("becd,edf->becf", buf, params["w_gate"].to(ct)),
        torch.einsum("becd,edf->becf", buf, params["w_up"].to(ct)))
    h = F.silu(g) * u
    out_buf = torch.einsum("becf,efd->becd", h, params["w_down"].to(ct))

    g = out_buf[bidx, flat_e, slot.clamp_max(cap - 1)]           # (B, S*k, d)
    g = torch.where(in_cap[..., None], g, torch.zeros((), dtype=ct,
                                                      device=dev))
    w = gate_w.reshape(B, S * k, 1).to(ct)
    return (g * w).reshape(B, S, k, d).sum(dim=2)


# ---------------------------------------------------------------------------
# CSR (dropless, sorted) dispatch
# ---------------------------------------------------------------------------
def moe_csr(params, x_flat: torch.Tensor, expert_ids: torch.Tensor,
            gate_w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tokens sorted by expert (CSR row order); one SwiGLU product per
    expert over its rows (the reference's ``ragged_dot`` with
    ``group_sizes`` = row-pointer differences).  Dropless.  Reads the group
    sizes back to the host (one sync); an expert with no row computes
    nothing."""
    ct = x_flat.dtype
    T, d = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    e0, e1 = mesh_context().shard(moe_spec(cfg)["w_gate"], 0)
    flat_e = expert_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)                  # CSR ordering
    xs = torch.repeat_interleave(x_flat, k, dim=0)[order]       # (T*k, d)
    sizes = torch.bincount(flat_e, minlength=E).tolist()

    # the rank's experts (all of them off a mesh); another rank's rows
    # read zero here and are added by that rank
    outs, start = [], 0
    for e, n in enumerate(sizes):
        if n and e0 <= e < e1:
            outs.append(_swiglu(xs[start:start + n],
                                params["w_gate"][e - e0].to(ct),
                                params["w_up"][e - e0].to(ct),
                                params["w_down"][e - e0].to(ct)))
        elif n:
            outs.append(xs.new_zeros((n, d)))
        start += n
    out = torch.empty_like(xs)
    out[order] = torch.cat(outs)                                # undo sort
    w = gate_w.reshape(-1, 1).to(ct)
    return (out * w).reshape(T, k, d).sum(dim=1)


# ---------------------------------------------------------------------------
# block-level apply with the auto-tuning rule
# ---------------------------------------------------------------------------
def moe_apply(params, x: torch.Tensor, cfg: ModelConfig,
              d_star: float = DEFAULT_D_STAR,
              seq_chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Dispatch per ``cfg.moe_dispatch``.

    Long sequences run the ELL dispatch in ``seq_chunk`` slices: capacity is
    per chunk (GShard group semantics) and the dispatch buffers stay bounded
    by the chunk.  ``"auto"`` reads D_mat to the host and runs one branch."""
    mc = mesh_context()
    spec = moe_spec(cfg)["w_gate"]
    split = mc.splits(spec, 0) or mc.splits(spec, 2)
    if mc.seq_split:
        if not split:
            raise ValueError("sequence parallelism needs the experts or "
                             f"their ffn split over the model axis of "
                             f"{mc.tp}")
        x = C.seq_gather(x, mc)
    B, S, d = x.shape
    real = (None if mc.real_rows is None
            else mc.real_rows.repeat_interleave(S))
    x_flat = x.reshape(B * S, d)
    expert_ids_f, gate_w_f, aux = route(params, x_flat, cfg, real)
    # sharded experts or ffn: the rank's output is a partial sum, so the
    # gradients of its input and gate weights are partial too
    if split:
        gate_w_f = C.tp_copy(gate_w_f, mc)
        if not mc.seq_split:    # (the gather's backward sums them)
            x = C.tp_copy(x, mc)
            x_flat = x.reshape(B * S, d)
    expert_ids = expert_ids_f.reshape(B, S, cfg.top_k)
    gate_w = gate_w_f.reshape(B, S, cfg.top_k)

    if cfg.moe_dispatch == "ell":
        if S > seq_chunk and S % seq_chunk == 0:
            y = torch.cat([moe_ell(params, x[:, c:c + seq_chunk],
                                   expert_ids[:, c:c + seq_chunk],
                                   gate_w[:, c:c + seq_chunk], cfg)
                           for c in range(0, S, seq_chunk)], dim=1)
        else:
            y = moe_ell(params, x, expert_ids, gate_w, cfg)
    elif cfg.moe_dispatch == "csr":
        y = moe_csr(params, x_flat, expert_ids_f, gate_w_f, cfg
                    ).reshape(B, S, d)
    elif cfg.moe_dispatch == "auto":
        # the paper's on-line phase, per call: D_mat < D* -> ELL (one read
        # back; only the chosen branch runs)
        d_mat = dispatch_d_mat(expert_ids_f, cfg.n_experts, real)
        if bool(d_mat < d_star):
            y = moe_ell(params, x, expert_ids, gate_w, cfg)
        else:
            y = moe_csr(params, x_flat, expert_ids_f, gate_w_f, cfg
                        ).reshape(B, S, d)
    else:
        raise ValueError(cfg.moe_dispatch)
    if mc.seq_split:
        return C.seq_scatter(y, mc), aux
    return (C.tp_reduce(y, mc) if split else y), aux


__all__ = ["moe_spec", "moe_apply", "moe_ell", "moe_csr", "route",
           "dispatch_d_mat", "learn_d_star", "capacity_of", "DEFAULT_D_STAR"]
