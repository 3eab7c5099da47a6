"""Device and dtype helpers shared by every module of the port.

The device is always explicit.  :func:`default_device` is the CUDA card and
*raises* when there is none: nothing in this package falls back to the CPU
on its own — a caller who wants the CPU says ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]

#: value dtypes the formats and kernels take
VALUE_DTYPES = (torch.float32, torch.bfloat16)


def default_device() -> torch.device:
    """The CUDA device this process computes on.  Raises ``RuntimeError``
    when no card is present (pass ``device="cpu"`` to run on the host)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run on the host")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> ``torch.device``."""
    if device is None:
        return default_device()
    return torch.device(device)


def result_dtype(data_dtype: torch.dtype, x_dtype: torch.dtype) -> torch.dtype:
    """Output dtype of ``A @ x``: ``promote_types(data, x)`` (bf16 x bf16 ->
    bf16, bf16 x f32 -> f32), the same lattice the JAX package's
    ``result_type`` walks for these dtypes."""
    return torch.promote_types(data_dtype, x_dtype)


# -- host views --------------------------------------------------------------
# numpy has no bfloat16.  Host code in this package only *moves* values
# (gather, pad with zero), so a bf16 tensor crosses to numpy as its int16 bit
# pattern (zero is all-zero bits in both) and comes back with ``from_host``.
def to_host(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array on the host (bf16 as its int16 bit pattern)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def from_host(a: np.ndarray, dtype: Optional[torch.dtype] = None,
              device: DeviceLike = "cpu") -> torch.Tensor:
    """numpy array -> tensor; ``dtype=torch.bfloat16`` reinterprets an int16
    bit-pattern array produced by :func:`to_host`."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # torch tensors are always writable
        a = a.copy()
    t = torch.from_numpy(a)
    if dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    elif dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(torch.device(device))


__all__ = ["default_device", "resolve_device", "result_dtype", "to_host",
           "from_host", "VALUE_DTYPES", "DeviceLike"]
