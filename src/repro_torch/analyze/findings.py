"""The shared finding model for every ``repro_torch.analyze`` pass.

All three passes (plan lint, registry audit, AST lint) report through one
:class:`Finding` shape so the CLI, the :class:`~repro_torch.core.plan_store
.PlanStore` quarantine hook, and ``SpMVService.register(strict_lint=)``
consume a single vocabulary: ``severity`` is ``"error"`` (the artifact or
source must not ship) or ``"warn"`` (suspicious but servable).

This module is stdlib-only by contract — it sits underneath the
framework-free CLI path (rule RPA003 enforces that mechanically).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

ERROR = "error"
WARN = "warn"


@dataclass(frozen=True)
class Finding:
    """One lint/audit result.

    ``rule`` is the stable identifier (``RPL0xx`` plan lint, ``RPR0xx``
    registry audit, ``RPA0xx`` AST lint — catalog in docs/analysis.md;
    the port's Hopper rules in ``repro_torch.analyze.planlint``).
    ``where`` locates it: a file path for source rules, a JSON path
    (``shards[2].plan.geometry.spmv``) for plan rules.  ``line`` is
    1-based for source findings, 0 when not applicable."""
    rule: str
    severity: str
    message: str
    where: str = ""
    line: int = 0

    def render(self) -> str:
        loc = self.where or "<input>"
        if self.line:
            loc = f"{loc}:{self.line}"
        return f"{loc}: {self.rule} [{self.severity}] {self.message}"


class PlanLintError(ValueError):
    """A plan artifact failed lint at a trust boundary that was asked to
    be strict (``SpMVService.register(strict_lint=True)``).  Carries the
    findings so callers can log or display them."""

    def __init__(self, message: str, findings: Sequence[Finding] = ()):
        super().__init__(message)
        self.findings: Tuple[Finding, ...] = tuple(findings)


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == ERROR]


def has_errors(findings: Iterable[Finding]) -> bool:
    return any(f.severity == ERROR for f in findings)


def render(findings: Iterable[Finding]) -> str:
    return "\n".join(f.render() for f in findings)


__all__ = ["ERROR", "WARN", "Finding", "PlanLintError", "errors",
           "has_errors", "render"]
