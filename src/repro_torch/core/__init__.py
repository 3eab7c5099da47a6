"""Core: the paper's contribution — sparse formats, run-time transformation,
SpMV references, and the D_mat–R_ell auto-tuning method."""
from .formats import (BCSR, BucketedELL, CCS, COO, CSR, ELL, MatrixStats,
                      from_numpy, memory_bytes, to_numpy)
from .transform import (csr_from_dense, csr_from_rows, device_csr_to_ccs,
                        device_csr_to_coo_col, device_csr_to_coo_row,
                        device_csr_to_ell, host_csr_to_bcsr, host_csr_to_ccs,
                        host_csr_to_ccs_paper, host_csr_to_coo_col,
                        host_csr_to_coo_row, host_csr_to_ell,
                        host_csr_to_sell, TRANSFORMS_HOST)
from . import dispatch
from .spmv import (spmm, spmv, spmv_bcsr, spmv_ccs, spmv_coo, spmv_csr,
                   spmv_dense, spmv_ell, spmv_sell, spmm_bcsr, spmm_ccs,
                   spmm_coo, spmm_csr, spmm_ell, spmm_sell)
from .autotune import (AutoTunedSpMV, Decision, MachineModel, TuningDB,
                       decide_cost_model, decide_generalized, decide_paper,
                       offline_phase, time_fn)
from .kernel_tune import (GeometryRecord, KernelTuner, TileGeometry,
                          candidate_geometries, nearest_geometry)
from .plan import (SHARDED_SCHEMA_VERSION, BlockPlan, ExecutionPlan,
                   PlanError, PlanFingerprint, PlanSchemaError,
                   PlannedMatrix, Planner, ShardedPlan, TransformRecipe,
                   apply_transform)
from .plan_store import PlanStore, fingerprint_key
from .suite import TABLE1, paper_suite, synthesize, verify_suite
from .policy import MemoryPolicy
