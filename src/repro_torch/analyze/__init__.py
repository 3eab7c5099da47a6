"""``repro_torch.analyze`` — static analysis for plans, registries, and
source.

Three passes behind one CLI (``python -m repro_torch.analyze``), all
stdlib-only (no torch, no JAX) so they run before any launch and inside a
bare CI job:

* :mod:`.planlint` — lint ``ExecutionPlan`` / ``ShardedPlan`` JSON
  (rules ``RPL0xx``): schema, the launch limits of
  ``repro_torch.launch_shapes`` (the helpers the kernel wrappers call),
  slab bounds, the shared memory of the Hopper launches, SELL bucket tables, hybrid/sharded partitions.
  Wired into :class:`~repro_torch.core.plan_store.PlanStore` loads (errors
  quarantine with reason ``"lint"``), ``SpMVService.register
  (strict_lint=)``, and the ``Planner``'s self-check.
* :mod:`.registry` — audit the port's dispatch registry against its
  transform table, its tuner grid, and the documented telemetry vocabulary
  (``RPR0xx``).
* :mod:`.astlint` — repo-contract source lint (``RPA0xx``) with
  ``# repro: noqa[RPAxxx]`` waivers; RPA003 keeps JAX and the JAX package
  out of the port.
"""
from .astlint import lint_paths, lint_source
from .findings import ERROR, WARN, Finding, PlanLintError, errors, \
    has_errors, render
from .planlint import DEFAULT_SMEM_BUDGET, lint_envelope, lint_plan, \
    lint_text
from .registry import audit

__all__ = ["ERROR", "WARN", "Finding", "PlanLintError", "errors",
           "has_errors", "render", "DEFAULT_SMEM_BUDGET", "lint_plan",
           "lint_envelope", "lint_text", "audit", "lint_source",
           "lint_paths"]
