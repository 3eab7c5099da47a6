"""Hand-written CUDA kernels for the compute hot path (SpMV and SpMM in ELL,
CSR, COO, CCS and BCSR) + wrappers.  Each kernel module holds the wrappers, their plain
PyTorch versions and a launch counter per kernel; ``ops`` holds the
format-level entry points and registers the kernel tier of
:mod:`repro_torch.core.dispatch`."""
from typing import Dict

from . import bcsr_spmv as _bcsr
from . import ccs_spmv as _ccs
from . import coo_spmv as _coo
from . import csr_spmv as _csr
from . import ell_spmv as _ell

_WRAPPERS = {"ell_spmv": _ell.ell_spmv, "csr_spmv": _csr.csr_spmv,
             "coo_spmv": _coo.coo_spmv, "ell_spmm": _ell.ell_spmm,
             "csr_spmm": _csr.csr_spmm, "coo_spmm": _coo.coo_spmm,
             "ccs_spmv": _ccs.ccs_spmv, "ccs_spmm": _ccs.ccs_spmm,
             "bcsr_spmv": _bcsr.bcsr_spmv, "bcsr_spmm": _bcsr.bcsr_spmm}


def launch_counts() -> Dict[str, int]:
    """Kernel launches made so far, per kernel."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


__all__ = ["launch_counts", "reset_launch_counts"]
