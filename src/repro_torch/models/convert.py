"""Parameters of the JAX package's model in the port's layout.

The reference's tree (``repro.models.init``) holds float32 masters, each
position of the layer pattern stacked over its repetitions under
``scan/pos{i}`` (leading axis = repetition) and the remainder layers under
``rem/rem{i}``.  :func:`params_from_jax` takes that tree as numpy arrays and
returns the port's: one dict per layer under ``layers`` (layer
``r * period + i`` is repetition ``r`` of position ``i``; the remainder
follows) and zamba2's unstacked ``shared`` block as it is, each matmul
weight stored once in the compute dtype (the cast the reference applies on
every call, so the numbers are equal) and each norm scale, and each matrix
the reference reads in float32 (``model.storage_dtype``), in float32.
:func:`params_to_jax` is its inverse (the port's tree as the reference's,
float32 numpy arrays), and :func:`opt_state_to_jax` /
:func:`opt_state_from_jax` carry the optimizer state the same way: a
checkpoint either package writes restores in the other.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..sharding.rules import ParamSpec, stack_spec, tree_map
from .blocks import block_spec, shared_block_spec
from .layers import embed_spec, lm_head_spec, rms_norm_spec
from .model import model_spec, storage_dtype


def jax_spec(cfg: ModelConfig) -> Any:
    """The reference's spec tree (its ``model_spec``): each position of
    the layer pattern stacked over its repetitions under ``scan/pos{i}``,
    the remainder under ``rem/rem{i}``, zamba2's ``shared`` block as it
    is.  Its leaves' shapes are the reference's; the checkpoint restores
    into it."""
    spec: Any = {"embed": embed_spec(cfg),
                 "final_norm": rms_norm_spec(cfg.d_model),
                 "head": lm_head_spec(cfg)}
    if cfg.scan_reps > 0:
        spec["scan"] = {f"pos{i}": stack_spec(block_spec(kind, cfg),
                                              cfg.scan_reps, "layers")
                        for i, kind in enumerate(cfg.layer_pattern)}
    spec["rem"] = {f"rem{i}": block_spec(kind, cfg)
                   for i, kind in enumerate(cfg.remainder_pattern)}
    if "shared" in model_spec(cfg):
        spec["shared"] = shared_block_spec(cfg)
    return spec


def _walk(spec: Any, src: Any, path: str, put):
    if isinstance(spec, dict):
        if not isinstance(src, dict) or set(src) != set(spec):
            raise ValueError(f"{path or 'params'}: expected keys "
                             f"{sorted(spec)}, got "
                             f"{sorted(src) if isinstance(src, dict) else src}")
        return {k: _walk(spec[k], src[k], f"{path}/{k}", put)
                for k in spec}
    return put(spec, src, path)


def _rows(a):
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def params_from_jax(tree: Any, cfg: ModelConfig, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None):
    """The port's parameters from the reference's tree of numpy arrays (or
    anything ``np.asarray`` takes, or tensors), on ``device`` (default: the
    card).
    ``dtype`` is the dtype of the matmul weights (default
    ``cfg.compute_dtype``); the float32 leaves stay float32."""
    dev = resolve_device(device)
    spec = model_spec(cfg)

    def put(s: ParamSpec, a, path: str) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.require(a, np.float32, ["C", "W"]))
        if tuple(a.shape) != tuple(s.shape):
            raise ValueError(f"{path}: shape {tuple(a.shape)}, expected "
                             f"{s.shape}")
        want = storage_dtype(s, cfg)
        if dtype is not None and want != torch.float32:
            want = dtype
        return a.to(device=dev, dtype=want).contiguous()

    period, reps = cfg.period, cfg.scan_reps
    layers = []
    for r in range(reps):
        for i in range(period):
            stacked = tree["scan"][f"pos{i}"]
            layers.append(tree_map(lambda a: _rows(a)[r], stacked))
    for i in range(len(cfg.remainder_pattern)):
        layers.append(tree["rem"][f"rem{i}"])
    src = {"embed": tree["embed"], "final_norm": tree["final_norm"],
           "head": tree.get("head", {})}
    if "shared" in spec:        # one set, not stacked
        src["shared"] = tree["shared"]
    out = _walk({k: v for k, v in spec.items() if k != "layers"}, src, "",
                put)
    out["layers"] = [_walk(s, layer, f"/layers/{n}", put)
                     for n, (s, layer) in enumerate(zip(spec["layers"],
                                                        layers))]
    # the keys in model_spec's order, as init gives them: trees are zipped
    # leaf by leaf in that order (the optimizer's moments with the params)
    return {k: out[k] for k in spec}


def _host(t: torch.Tensor) -> np.ndarray:
    """A float32 copy on the host (never a view of the live tensor)."""
    return t.detach().to(device="cpu", dtype=torch.float32,
                         copy=True).numpy()


def _stack(trees: list) -> Any:
    """One tree whose leaves stack the leaves of ``trees`` on a new first
    axis (the reference's layout of a position over its repetitions)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def params_to_jax(params: Any, cfg: ModelConfig) -> Any:
    """The reference's tree of float32 numpy arrays from the port's
    parameters (any dtype, any device): layer ``r * period + i`` goes to
    repetition ``r`` of ``scan/pos{i}``, the remainder to ``rem/rem{i}``,
    ``shared`` as it is.  ``params_from_jax`` of it gives ``params`` back
    (float32 leaves exactly)."""
    host = tree_map(_host, params)
    out: Any = {"embed": host["embed"], "final_norm": host["final_norm"],
                "head": host.get("head", {})}
    period, reps = cfg.period, cfg.scan_reps
    layers = host["layers"]
    if reps > 0:
        out["scan"] = {f"pos{i}": _stack([layers[r * period + i]
                                          for r in range(reps)])
                       for i in range(period)}
    out["rem"] = {f"rem{i}": layers[reps * period + i]
                  for i in range(len(cfg.remainder_pattern))}
    if "shared" in host:
        out["shared"] = host["shared"]
    return out


def opt_state_to_jax(state: Any, cfg: ModelConfig) -> Any:
    """An optimizer state (``optim.AdamWState`` or ``AdamWMixedState``) with
    its trees in the reference's layout: ``step`` an int32 numpy scalar,
    ``m``, ``v`` (and ``master``) through :func:`params_to_jax`.  The
    result is a state of the same type, whose fields a checkpoint names as
    the reference's do (``['opt'].step``, ``['opt'].m[...]``)."""
    fields = {f: params_to_jax(getattr(state, f), cfg)
              for f in state._fields if f != "step"}
    step = np.asarray(int(state.step), dtype=np.int32)
    return type(state)(step=step, **fields)


def opt_state_from_jax(state: Any, cfg: ModelConfig,
                       device: DeviceLike = None) -> Any:
    """The port's optimizer state from one in the reference's layout (the
    reference's ``AdamWState`` / ``AdamWMixedState``, or what
    :func:`opt_state_to_jax` gives): every tree in float32 on ``device``
    (default: the card), ``step`` an int32 scalar tensor."""
    from ..optim import adamw
    dev = resolve_device(device)
    fields = {f: params_from_jax(getattr(state, f), cfg, device=dev,
                                 dtype=torch.float32)
              for f in state._fields if f != "step"}
    step = state.step
    if not isinstance(step, torch.Tensor):
        step = torch.from_numpy(np.array(step))
    step = step.to(device=dev, dtype=torch.int32)
    kind = (adamw.AdamWMixedState if "master" in fields
            else adamw.AdamWState)
    return kind(step=step, **fields)


__all__ = ["params_from_jax", "params_to_jax", "opt_state_to_jax",
           "opt_state_from_jax", "jax_spec"]
