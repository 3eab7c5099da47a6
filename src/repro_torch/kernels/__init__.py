"""Hand-written CUDA kernels for the compute hot path (SpMV in ELL, CSR and
COO) + wrappers.  Each kernel module holds the wrapper, its plain PyTorch
version and a launch counter; ``ops`` holds the format-level entry points
and registers the kernel tier of :mod:`repro_torch.core.dispatch`."""
from typing import Dict

from . import coo_spmv as _coo
from . import csr_spmv as _csr
from . import ell_spmv as _ell

_WRAPPERS = {"ell_spmv": _ell.ell_spmv, "csr_spmv": _csr.csr_spmv,
             "coo_spmv": _coo.coo_spmv}


def launch_counts() -> Dict[str, int]:
    """Kernel launches made so far, per kernel."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


__all__ = ["launch_counts", "reset_launch_counts"]
