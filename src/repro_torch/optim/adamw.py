"""AdamW with a cosine schedule and global-norm clipping.

The port of the JAX package's ``optim/adamw.py``: the same config, states,
schedule and update, in float32 under ``torch.no_grad``.  Bias correction,
the learning rate and the clip factor are float32 scalars on the
parameters' device, computed in the reference's order, so a step reads
nothing back to the host.  A state's ``m`` and ``v`` (and ``master``) are
trees like the parameters (dicts and lists of tensors).

``update`` and ``update_mixed`` return new tensors; with ``inplace=True``
they write the new values into the given parameters and moments instead
and return those (what the reference's jitted step does with donated
buffers), so a full-width step holds one copy of its state.  Each leaf is
updated on its own, so the temporaries are one leaf's size.

The ZeRO sharding of the moments is the reference's mesh half: on one card
nothing shards them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from ..sharding.rules import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any               # like params, float32
    v: Any               # like params, float32


class AdamWMixedState(NamedTuple):
    """Mixed precision: the *working* parameters are bfloat16; the float32
    master copy lives here."""
    step: torch.Tensor
    m: Any
    v: Any
    master: Any          # float32, like params


def _device_of(tree: Any) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def init(params: Any) -> AdamWState:
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        m=tree_map(torch.zeros_like, params),
        v=tree_map(torch.zeros_like, params))


def init_mixed(params_f32: Any) -> AdamWMixedState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return AdamWMixedState(
        step=torch.zeros((), dtype=torch.int32,
                         device=_device_of(params_f32)),
        m=tree_map(zeros, params_f32), v=tree_map(zeros, params_f32),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params_f32))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_ratio *
    lr`` at ``total_steps``; a float32 scalar (on ``step``'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(leaves).sum().sqrt()


def _scalars(cfg: AdamWConfig, grads: Any, step: torch.Tensor):
    """(grad norm, clip factor, lr, 1 - b1^t, 1 - b2^t) as float32 scalars,
    each as the reference computes it."""
    gnorm = global_norm(grads)
    clip = torch.full_like(gnorm, cfg.clip_norm)
    scale = torch.clamp(clip / gnorm.clamp_min(1e-9), max=1.0)
    lr = schedule(cfg, step)
    t = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, t)
    b2c = 1.0 - torch.pow(cfg.b2, t)
    return gnorm, scale, lr, b1c, b2c


def _moments(cfg: AdamWConfig, g, m, v, scale):
    g = g.float() * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    return m, v


def _rebuild(tree: Any, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any,
           inplace: bool = False) -> Tuple[Any, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm)."""
    step = state.step + 1
    gnorm, scale, lr, b1c, b2c = _scalars(cfg, grads, step)
    new_p, new_m, new_v = [], [], []
    for p, g, m0, v0 in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state.m), tree_leaves(state.v)):
        m, v = _moments(cfg, g, m0, v0, scale)
        mh = m / b1c
        vh = v / b2c
        p32 = p.float()
        step_ = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        p_new = (p32 - lr * step_).to(p.dtype)
        if inplace:
            p_new, m, v = p.copy_(p_new), m0.copy_(m), v0.copy_(v)
        new_p.append(p_new)
        new_m.append(m)
        new_v.append(v)
    return (_rebuild(params, new_p),
            AdamWState(step=step, m=_rebuild(state.m, new_m),
                       v=_rebuild(state.v, new_v)), gnorm)


@torch.no_grad()
def update_mixed(cfg: AdamWConfig, grads: Any, state: AdamWMixedState,
                 inplace: bool = False
                 ) -> Tuple[Any, AdamWMixedState, torch.Tensor]:
    """Mixed-precision step: grads (any dtype) -> float32 master update ->
    fresh bfloat16 working params.  Returns (params_bf16, state,
    grad_norm)."""
    step = state.step + 1
    gnorm, scale, lr, b1c, b2c = _scalars(cfg, grads, step)
    work, new_master, new_m, new_v = [], [], [], []
    for master, g, m0, v0 in zip(tree_leaves(state.master),
                                 tree_leaves(grads), tree_leaves(state.m),
                                 tree_leaves(state.v)):
        m, v = _moments(cfg, g, m0, v0, scale)
        step_ = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + \
            cfg.weight_decay * master
        master_new = master - lr * step_
        if inplace:
            master_new, m, v = (master.copy_(master_new), m0.copy_(m),
                                v0.copy_(v))
        work.append(master_new.to(torch.bfloat16))
        new_master.append(master_new)
        new_m.append(m)
        new_v.append(v)
    return (_rebuild(state.master, work),
            AdamWMixedState(step=step, m=_rebuild(state.m, new_m),
                            v=_rebuild(state.v, new_v),
                            master=_rebuild(state.master, new_master)),
            gnorm)


__all__ = ["AdamWConfig", "AdamWState", "AdamWMixedState", "init",
           "init_mixed", "update", "update_mixed", "schedule",
           "global_norm"]
