"""repro_torch — the PyTorch/CUDA port of the auto-tuned run-time
sparse-format transformation for SpMV (Katagiri & Sato).

Same layout and public names as the JAX package ``repro`` (``core/``,
``kernels/``, ``obs/``, ``api``), holding ``torch.Tensor``s and launching
hand-written CUDA kernels on an NVIDIA Hopper card::

    from repro_torch import Planner, ExecutionPlan

    plan = Planner(db=db).plan(csr)      # decide, one artifact
    plan.save("plan.json")
    P = ExecutionPlan.load("plan.json").bind(csr)
    y = P @ x

Entry points run on the CUDA device unless the caller passes
``device="cpu"``.  Attribute access is lazy so ``import repro_torch`` stays
lightweight; the full surface lives in :mod:`repro_torch.api`.
"""

__version__ = "0.1.0"

# lazily re-exported from repro_torch.api (keeps the import free of torch)
_API_EXPORTS = (
    "Planner", "ExecutionPlan", "PlannedMatrix", "BlockPlan",
    "TransformRecipe", "PlanFingerprint", "PlanError", "PlanSchemaError",
    "TuningDB", "TileGeometry", "offline_phase", "MachineModel",
    "MatrixStats", "csr_from_dense", "csr_from_rows", "obs", "Telemetry",
)

__all__ = ["__version__", "api", *_API_EXPORTS]


def __getattr__(name: str):
    import importlib
    if name == "obs":
        # resolved directly (not via repro_torch.api) so the stdlib-only
        # telemetry surface never drags torch into the importing process
        return importlib.import_module("repro_torch.obs")
    if name in _API_EXPORTS or name == "api":
        api = importlib.import_module("repro_torch.api")
        return api if name == "api" else getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
