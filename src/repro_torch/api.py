"""repro_torch.api — the one-import surface of the auto-tuning pipeline.

The paper's method is a single pipeline: profile the machine (off-line
phase), read the matrix's D_mat, decide the format, transform at run
time, launch.  This module is that pipeline as one importable surface,
organized around the portable decision artifact — the
:class:`~repro_torch.core.plan.ExecutionPlan`:

    from repro_torch import api
    from repro_torch.kernels import ops

    # off-line, once per machine class: suite timings on the card
    db = api.offline_phase(suite, machine="h100",
                           spmv_impls=ops.KERNEL_SPMV_IMPLS)
    db.save("tuningdb.h100.json")

    # plan: decision rule + format + transform recipe + launch geometry,
    # one versioned JSON artifact (same schema as the JAX package's)
    plan = api.Planner(db=db, rule="paper", tier="kernel").plan(csr)
    plan.save("plan.json")

    # replay anywhere: bind to the matrix and serve
    P = api.ExecutionPlan.load("plan.json").bind(csr)
    y = P @ x                      # SpMV
    Y = P @ X                      # SpMM, X: (n_cols, B)

    # a format forced by name: CCS, or BCSR in 8 x 8 blocks
    P = api.Planner(db=db, tier="kernel").plan(csr, fmt="bcsr").bind(csr)

    # the batched path, launch geometry searched on the card
    tuner = api.KernelTuner(db)
    P = api.Planner(db, tuner=tuner).plan(csr, batch=128).bind(csr)
    Y = P @ X                      # X: (n_cols, 128)

Names match ``repro.api`` for everything the port holds so far.
"""
from repro_torch.core.autotune import (Decision, MachineModel, OfflineRecord,
                                       TuningDB, decide_cost_model,
                                       decide_generalized, decide_paper,
                                       offline_phase)
from repro_torch.core.formats import (BCSR, BucketedELL, CCS, COO, CSR, ELL,
                                      MatrixStats, MatrixValidationError,
                                      from_numpy, memory_bytes, to_numpy)
from repro_torch.core.kernel_tune import (GRID_FORMATS, GeometryRecord,
                                          KernelTuner, TileGeometry,
                                          candidate_geometries,
                                          nearest_geometry)
from repro_torch.core.plan import (SCHEMA_VERSION, BlockPlan, ExecutionPlan,
                                   PlanError, PlanFingerprint,
                                   PlanSchemaError, PlannedMatrix, Planner,
                                   TransformRecipe, apply_transform)
from repro_torch.core.policy import MemoryPolicy
from repro_torch.core.transform import (TRANSFORMS_HOST, csr_from_dense,
                                        csr_from_rows)
from repro_torch.device import default_device
from repro_torch.obs import FakeClock, InMemorySink, JsonlSink, Telemetry
from repro_torch import obs

__all__ = [
    # the plan API (the public face)
    "SCHEMA_VERSION", "ExecutionPlan", "PlannedMatrix", "Planner",
    "BlockPlan", "TransformRecipe", "PlanFingerprint", "PlanError",
    "PlanSchemaError", "apply_transform",
    # offline phase + persistence
    "offline_phase", "TuningDB", "OfflineRecord", "MachineModel",
    # kernel launch-geometry tuning (GRID_FORMATS is importable here too,
    # but kept out of __all__ as the reference keeps it)
    "KernelTuner", "TileGeometry", "GeometryRecord",
    "candidate_geometries", "nearest_geometry",
    # formats + construction
    "CSR", "CCS", "COO", "ELL", "BCSR", "BucketedELL", "MatrixStats",
    "MatrixValidationError", "memory_bytes", "csr_from_dense",
    "csr_from_rows", "TRANSFORMS_HOST", "from_numpy", "to_numpy",
    "default_device",
    # observability (repro_torch.obs is the full surface)
    "obs", "Telemetry", "InMemorySink", "JsonlSink", "FakeClock",
    # policy + decisions
    "MemoryPolicy", "Decision",
    "decide_paper", "decide_generalized", "decide_cost_model",
]
