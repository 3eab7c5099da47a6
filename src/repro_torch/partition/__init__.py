"""Partitioned hybrid-format SpMV: per-row-block auto-tuning subsystem.

Splits a CSR matrix into row blocks (fixed / nnz-balanced / greedy
variance-splitting), runs the D_mat–R decision per block under the memory
policy, and materializes a ``HybridMatrix`` whose blocks each carry their
own storage format, served block by block through each format's kernel."""
from .strategies import (PARTITIONERS, partition_balanced_nnz,
                         partition_fixed, partition_for_devices,
                         partition_variance)
from .hybrid import (BLOCK_FORMATS, BlockDecision, HybridMatrix,
                     HybridReport, build_hybrid, choose_block_format,
                     host_csr_to_hybrid, slice_csr, slice_csr_cols,
                     spmm_hybrid, spmv_hybrid, take_rows_csr)

__all__ = [
    "PARTITIONERS", "partition_fixed", "partition_balanced_nnz",
    "partition_variance", "partition_for_devices",
    "BLOCK_FORMATS", "HybridMatrix", "BlockDecision", "HybridReport",
    "build_hybrid", "choose_block_format", "host_csr_to_hybrid",
    "slice_csr", "slice_csr_cols", "take_rows_csr", "spmv_hybrid",
    "spmm_hybrid",
]
