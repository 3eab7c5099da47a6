"""``python -m repro_torch.analyze`` — the framework-free static-analysis
CLI of the port.

    python -m repro_torch.analyze lint-plan plan.json [...] [--smem-budget KiB]
    python -m repro_torch.analyze audit [--src src] [--docs docs/observability.md]
    python -m repro_torch.analyze lint-src src/repro_torch [more paths ...]

Exit codes: 0 clean (warnings allowed unless ``--strict-warn``), 1 at
least one ERROR finding, 2 usage error.  ``lint-plan`` accepts both bare
plan payloads and ``PlanStore`` envelopes (``{store_version, sha256,
plan}``) and verifies the checksum on the latter.  None of the
subcommands import torch or JAX — all three run on a bare interpreter.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

from . import astlint, planlint, registry
from .findings import Finding, has_errors, render


def _report(findings: List[Finding], strict_warn: bool,
            label: str) -> int:
    if findings:
        print(render(findings))
    bad = has_errors(findings) or (strict_warn and findings)
    n_err = sum(1 for f in findings if f.severity == "error")
    n_warn = len(findings) - n_err
    print(f"{label}: {n_err} error(s), {n_warn} warning(s)")
    return 1 if bad else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="static analysis for plans, registries, and source "
                    "(framework-free)")
    parser.add_argument("--strict-warn", action="store_true",
                        help="exit nonzero on warnings too")
    sub = parser.add_subparsers(dest="cmd")

    p_plan = sub.add_parser("lint-plan",
                            help="lint ExecutionPlan/ShardedPlan/"
                                 "stream-artifact JSON (bare payloads "
                                 "or store envelopes)")
    p_plan.add_argument("paths", nargs="+", metavar="plan.json")
    p_plan.add_argument("--smem-budget", type=float, default=None,
                        metavar="KIB",
                        help="shared memory a CUDA block may take, for "
                             "RPL004, in KiB (default: an H100's, "
                             "226 KiB)")

    p_audit = sub.add_parser("audit",
                             help="cross-registry + telemetry-vocabulary "
                                  "consistency audit")
    p_audit.add_argument("--src", default="src")
    p_audit.add_argument("--docs", default="docs/observability.md")

    p_src = sub.add_parser("lint-src", help="AST lint (rules RPA0xx)")
    p_src.add_argument("paths", nargs="+", metavar="path")

    args = parser.parse_args(argv)
    if args.cmd is None:
        parser.print_help()
        return 2

    if args.cmd == "lint-plan":
        budget = None
        if args.smem_budget is not None:
            if args.smem_budget <= 0:
                parser.error("--smem-budget must be positive")
            budget = int(args.smem_budget * 1024)
        findings: List[Finding] = []
        for path in args.paths:
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    text = fh.read()
            except OSError as e:
                print(f"{path}: unreadable: {e}", file=sys.stderr)
                return 2
            for f in planlint.lint_text(text, smem_budget=budget):
                findings.append(Finding(f.rule, f.severity, f.message,
                                        where=f"{path}:{f.where}"
                                        if f.where else path,
                                        line=f.line))
        return _report(findings, args.strict_warn, "lint-plan")

    if args.cmd == "audit":
        return _report(registry.audit(src=args.src, docs=args.docs),
                       args.strict_warn, "audit")

    # lint-src
    return _report(astlint.lint_paths(args.paths), args.strict_warn,
                   "lint-src")


if __name__ == "__main__":
    sys.exit(main())
