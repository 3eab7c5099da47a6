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
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..sharding.rules import ParamSpec, tree_map
from .model import model_spec, storage_dtype


def _walk(spec: Any, src: Any, path: str, put):
    if isinstance(spec, dict):
        if not isinstance(src, dict) or set(src) != set(spec):
            raise ValueError(f"{path or 'params'}: expected keys "
                             f"{sorted(spec)}, got "
                             f"{sorted(src) if isinstance(src, dict) else src}")
        return {k: _walk(spec[k], src[k], f"{path}/{k}", put)
                for k in spec}
    return put(spec, src, path)


def params_from_jax(tree: Any, cfg: ModelConfig, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None):
    """The port's parameters from the reference's tree of numpy arrays (or
    anything ``np.asarray`` takes), on ``device`` (default: the card).
    ``dtype`` is the dtype of the matmul weights (default
    ``cfg.compute_dtype``); the float32 leaves stay float32."""
    dev = resolve_device(device)
    spec = model_spec(cfg)

    def put(s: ParamSpec, a, path: str) -> torch.Tensor:
        a = np.asarray(a)
        if tuple(a.shape) != tuple(s.shape):
            raise ValueError(f"{path}: shape {a.shape}, expected {s.shape}")
        want = storage_dtype(s, cfg)
        if dtype is not None and want != torch.float32:
            want = dtype
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=dev, dtype=want)

    period, reps = cfg.period, cfg.scan_reps
    layers = []
    for r in range(reps):
        for i in range(period):
            stacked = tree["scan"][f"pos{i}"]
            layers.append(tree_map(lambda a: np.asarray(a)[r], stacked))
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
    return out


__all__ = ["params_from_jax"]
