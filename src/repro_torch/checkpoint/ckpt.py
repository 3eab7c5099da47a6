"""Atomic, async checkpointing in the JAX package's on-disk format.

The port of ``checkpoint/ckpt.py``.  Layout (one directory per step):

    <dir>/step_000042/
        manifest.json      — tree keys, shapes, dtypes, codecs, content hashes
        leaf_00000.bin.zst — zstd-compressed raw bytes, one file per leaf
                             (``.bin``, uncompressed, without ``zstandard``)
        COMMIT             — written last; a checkpoint without it is
                             ignored (atomic-commit protocol)

A leaf's key is the reference's ``jax.tree_util.keystr`` of its path
(``['params']['embed']['tok']``, ``['opt'].step``) and the leaves are listed
in the reference's order (dict keys sorted, sequences and named tuples in
order), so a tree of the reference's layout saved by either package
restores in the other (the trainer writes its state through
``models.convert``).  Leaves are tensors or numpy arrays; a bfloat16 tensor
is stored as its raw bytes under the dtype name ``bfloat16``, as the
reference stores its own.

``restore`` places the leaves on one device; the reference's placement
under a tree of shardings (elastic re-shard) is multi-device (ROADMAP.md
item A16c).  ``AsyncCheckpointer`` moves serialization off the training
thread and keeps the latest K checkpoints.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

try:
    import zstandard as zstd
    HAVE_ZSTD = True
except ImportError:          # optional: fall back to uncompressed leaves
    zstd = None
    HAVE_ZSTD = False


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in the reference's flattening order and ``keystr``
    spelling; ``None`` and empty containers hold no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _leaf_paths(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaf_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure with ``leaves`` in :func:`_leaf_paths` order."""
    it = iter(leaves)

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: walk(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(walk(getattr(t, f)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)
    return walk(tree)


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(host array, dtype name); bfloat16 travels as its 16-bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return np.require(arr, requirements="C"), str(arr.dtype)


def _host_tree(tree: Any) -> Any:
    """``tree`` copied to the host: no leaf shares memory with the caller's
    (a float32 tensor on the CPU, and ``params_to_jax`` of it, are views of
    the live state, which the next in-place training step overwrites)."""
    leaves = [_to_host(leaf) for _, leaf in _leaf_paths(tree)]
    return _unflatten(tree, [_HostLeaf(np.array(arr, copy=True), dtype)
                             for arr, dtype in leaves])


class _HostLeaf:
    """A leaf already on the host (``AsyncCheckpointer`` copies the tree
    before the training step may overwrite the state's buffers)."""

    def __init__(self, arr: np.ndarray, dtype: str):
        self.arr, self.dtype = arr, dtype


def save(directory: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Write an atomic checkpoint; returns the final path."""
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    cctx = zstd.ZstdCompressor(level=3) if HAVE_ZSTD else None
    codec = "zstd" if HAVE_ZSTD else "none"
    manifest: Dict[str, Any] = {"step": step, "extra": extra or {},
                                "leaves": []}
    for i, (key, leaf) in enumerate(_leaf_paths(tree)):
        arr, dtype = ((leaf.arr, leaf.dtype) if isinstance(leaf, _HostLeaf)
                      else _to_host(leaf))
        raw = arr.tobytes()
        fname = f"leaf_{i:05d}.bin.zst" if HAVE_ZSTD else f"leaf_{i:05d}.bin"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(cctx.compress(raw) if cctx else raw)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(arr.shape),
            "dtype": dtype, "codec": codec,
            "sha256": hashlib.sha256(raw).hexdigest(),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if (name.startswith("step_") and not name.endswith(".tmp")
                and os.path.exists(os.path.join(full, "COMMIT"))):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def _from_raw(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return torch.from_numpy(arr)


def restore(directory: str, step: int, target_tree: Any,
            shardings: Any = None, verify: bool = False,
            device: DeviceLike = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree`` (its leaves need only
    a ``shape``: tensors, arrays, ``ParamSpec``s); every leaf a tensor on
    ``device`` (default: the card) in its stored dtype."""
    if shardings is not None:
        raise NotImplementedError(
            "restore(shardings=...) places leaves over a device mesh: "
            "multi-device, ROADMAP.md item A16c")
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    dctx = zstd.ZstdDecompressor() if HAVE_ZSTD else None
    leaves = []
    for key, tgt in _leaf_paths(target_tree):
        m = by_key[key]
        codec = m.get("codec", "zstd")  # pre-codec manifests were all zstd
        with open(os.path.join(path, m["file"]), "rb") as f:
            raw = f.read()
        if codec == "zstd":
            if dctx is None:
                raise RuntimeError(
                    f"checkpoint leaf {key} is zstd-compressed but the "
                    "zstandard package is not installed")
            raw = dctx.decompress(raw)
        if verify and hashlib.sha256(raw).hexdigest() != m["sha256"]:
            raise ValueError(f"checkpoint leaf {key}: sha256 mismatch")
        t = _from_raw(raw, m["dtype"], m["shape"])
        want = tuple(getattr(tgt, "shape", t.shape))
        if tuple(t.shape) != want:
            raise ValueError(f"checkpoint leaf {key}: shape "
                             f"{tuple(t.shape)}, expected {want}")
        leaves.append(t.to(dev))
    return _unflatten(target_tree, leaves), manifest["extra"]


def gc_keep_last(directory: str, keep: int = 3) -> None:
    steps = available_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpointing with at-most-one in flight."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        # copied to the host *before* returning, so the training step may
        # overwrite the state's buffers in place
        host_tree = _host_tree(tree)

        def work():
            try:
                save(self.directory, step, host_tree, extra)
                gc_keep_last(self.directory, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()


__all__ = ["save", "restore", "latest_step", "available_steps",
           "gc_keep_last", "AsyncCheckpointer", "HAVE_ZSTD"]
