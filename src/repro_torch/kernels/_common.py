"""Argument checks shared by the kernel wrappers, and their launch shapes.

The launch shapes live in :mod:`repro_torch.launch_shapes` (torch-free, so
the plan lint reads the same arithmetic) and are re-exported here."""
from __future__ import annotations

import torch

from ..device import VALUE_DTYPES
from ..launch_shapes import *  # noqa: F401,F403 (the launch arithmetic)

INT32_MAX = 2 ** 31 - 1
#: elements of the largest ``(entries, B)`` temporary a plain SpMM version
#: builds (256 MiB of float32): it walks the entries in chunks of this size
PLAIN_CHUNK_ELEMS = 1 << 26


def check_values(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype not in VALUE_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16; got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D; got shape "
                         f"{tuple(t.shape)}")


def check_index(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32; got {t.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} must have shape {tuple(like.shape)}; got "
                         f"{tuple(t.shape)}")


def check_same_device(ref: torch.Tensor, **others: torch.Tensor) -> None:
    for name, t in others.items():
        if t.device != ref.device:
            raise ValueError(f"{name} lies on {t.device}, expected "
                             f"{ref.device}: all operands of a kernel share "
                             f"one device")


def check_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")


def check_current_device(t: torch.Tensor) -> None:
    """A kernel launches on the current CUDA device's current stream, so its
    operands must live there."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"operands lie on {t.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}; wrap the "
                         f"call in torch.cuda.device(...)")


def current_stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream
