"""Build and load the CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``<build dir>/<name>-<hash>.so`` where the
hash covers the source, the shared header and the compiler flags, so an edit
rebuilds and an unchanged source is reused.  Nothing is built at import time:
:func:`load` compiles at first use, :func:`build_all` compiles every kernel
at once (one ``nvcc`` per source, all started together).

The build directory is ``build/repro_torch/`` at the root of the checkout.
No PyTorch header is included, so a source compiles in seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("ell_spmv", "csr_spmv", "coo_spmv", "ell_spmm", "csr_spmm",
           "coo_spmm", "ccs_spmv", "ccs_spmm", "bcsr_spmv", "bcsr_spmm",
           "decode_attention_int8")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
#: C signature of each library's entry point (every pointer and the stream
#: are ``c_void_p`` — ctypes would otherwise cut a pointer to 32 bits)
SIGNATURES: Dict[str, Sequence] = {
    # data, cols, extent (null: the whole band), x, y, n_rows, width,
    # row_stride, col_stride, lanes, rows_per_block, data_bf16, x_bf16, stream
    "ell_spmv": (_P, _P, _P, _P, _P, _I, _I, _L, _L, _I, _I, _I, _I, _P),
    # data, cols, indptr, x, y, scratch, n_rows, nnz_pad, n_slices, threads,
    # block_nnz, chunk, data_bf16, x_bf16, stream
    "csr_spmv": (_P,) * 6 + (_I,) * 8 + (_P,),
    # data, rows, cols, x, y, nnz, threads, block_nnz, chunk, data_bf16,
    # x_bf16, stream
    "coo_spmv": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    # data, cols, x, y, n_rows, width, row_stride, col_stride, B, kt, lanes,
    # per_lane, rows_per_block, data_bf16, x_bf16, stream
    "ell_spmm": (_P, _P, _P, _P, _I, _I, _L, _L, _I, _I, _I, _I, _I, _I, _I,
                 _P),
    # data, cols, indptr, x, y, n_rows, n_cols, B, kt, lanes, per_lane,
    # threads, rows_per_block, window, stage, data_bf16, x_bf16, stream
    "csr_spmm": (_P,) * 5 + (_I,) * 12 + (_P,),
    # data, rows, cols, x, y, nnz, B, kt, lanes, per_lane, threads,
    # block_nnz, run, data_bf16, x_bf16, stream
    "coo_spmm": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                 _I, _P),
    # data, rows, indptr, x, y, n_rows, n_cols, threads, cols_per_warp,
    # window, data_bf16, x_bf16, stream
    "ccs_spmv": (_P,) * 5 + (_I,) * 7 + (_P,),
    # data, rows, indptr, x, y, n_rows, n_cols, B, kt, lanes, per_lane,
    # threads, cols_per_block, window, rows_per_group, data_bf16, x_bf16,
    # stream
    "ccs_spmm": (_P,) * 5 + (_I,) * 12 + (_P,),
    # data, block_cols, indptr, x, y, n_rows, n_cols, block, threads,
    # data_bf16, x_bf16, stream
    "bcsr_spmv": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # data, block_cols, indptr, x, y, n_rows, n_cols, n_block_rows, block,
    # B, kt, lanes, per_lane, rows_per_block, mma_threads, slots, stride,
    # data_bf16, x_bf16, stream
    "bcsr_spmm": (_P,) * 5 + (_I,) * 14 + (_P,),
    # q, k_q, k_s, v_q, v_s, key_pos, q_pos, part_m, part_l, part_acc, out,
    # lse, counters, B, S, KV, G, Dh, lanes, threads, g_tile,
    # keys_per_split, splits, window, has_window, scale, softcap, q_bf16,
    # stream
    "decode_attention_int8": (_P,) * 13 + (_I,) * 12 + (_F, _F, _I, _P),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a non-zero ``cudaError_t``."""


def build_dir() -> Path:
    # <root>/src/repro_torch/kernels/build.py -> <root>/build/repro_torch
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked at PATH and $CUDA_HOME/bin): the "
        "CUDA kernels are compiled on the machine that holds the card")


def source_hash(name: str) -> str:
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{source_hash(name)}.so"


def _nvcc_command(name: str, out: Path) -> List[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: a reader never sees a partial file
    return log


def build_all(names: Sequence[str] = KERNELS,
              force: bool = False) -> Dict[str, str]:
    """Compile the named kernels in parallel; returns ``{name: compiler
    log}`` (empty for a kernel whose library was already built)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    started = []
    logs: Dict[str, str] = {}
    for name in names:
        if name not in SIGNATURES:
            raise KeyError(f"unknown kernel {name!r}; one of {KERNELS}")
        out = library_path(name)
        if out.exists() and not force:
            logs[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(_nvcc_command(name, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((name, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in started:
        try:
            logs[name] = _finish(name, proc, tmp, out)
        except KernelBuildError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if need be.  The entry
    point ``<name>_launch`` has its ``argtypes`` set."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = list(SIGNATURES[name])
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def launcher(name: str):
    """``<name>_launch`` of the loaded library."""
    return getattr(load(name), f"{name}_launch")


def check_launch(name: str, code: int) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if code != 0:
        raise KernelLaunchError(
            f"{name} kernel launch failed: cudaError {code}")


__all__ = ["KERNELS", "KernelBuildError", "KernelLaunchError", "build_all",
           "build_dir", "check_launch", "find_nvcc", "launcher",
           "library_path", "load", "source_hash"]
