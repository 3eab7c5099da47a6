"""Cross-registry consistency audit of the port (RPR0xx) — AST-extracted,
framework-free.

``repro_torch/core/dispatch.py`` makes the ``(format, op) x tier``
registry the single source of truth, but three adjacent tables can still
drift from it: the host transform table
(``repro_torch/core/transform.py::TRANSFORMS_HOST``), the tuner's
candidate-grid surface (``repro_torch/core/kernel_tune.py::GRID_FORMATS``),
and the telemetry vocabulary documented in ``docs/observability.md`` — the
JAX package's, which the port shares (the port emits only names it lists).
Each drift has a concrete failure mode — a registered format the planner
cannot transform to, a kernel the tuner silently serves with default
geometry, a dashboard watching an event name that nothing emits.

Everything here is read **statically**: provider modules are located by
parsing the ``_PROVIDERS`` literal in ``dispatch.py`` and their
``register_format`` / ``register_impl`` calls (including the
loop-over-tuple-literal idiom the providers use) are lifted from the AST,
never imported — so the audit runs with no array framework installed.

Rules:

  RPR001  every ``register_format`` name has reference-tier SpMV and SpMM
  RPR002  every kernel-tier impl is on the tuner's ``GRID_FORMATS``
          surface (hybrid composes tuned blocks and is exempt); a grid
          entry with no kernel is a stale-grid WARN
  RPR003  every reference-SpMV format has a ``TRANSFORMS_HOST`` recipe;
          a recipe with no impl is a WARN
  RPR004  every format with an impl is registered via ``register_format``
  RPR005  telemetry names emitted under ``src/repro_torch`` appear in the
          ``docs/observability.md`` vocabulary (a documented name the port
          does not emit is a WARN; the port emits the streaming tier's
          ``stream.*`` and the sharded tier's ``shard.*``/``sharded.*``
          names as the reference does)
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .findings import ERROR, WARN, Finding

#: the audited package, under ``src``
PACKAGE = "repro_torch"

_TEL_METHODS = ("counter", "gauge", "histogram", "event", "span")
_DOTTED = re.compile(r"`([a-z_][a-z0-9_]*(?:\.[a-z0-9_*]+)+)`")


def _parse(path: Path) -> Optional[ast.Module]:
    try:
        return ast.parse(path.read_text(encoding="utf-8"), str(path))
    except (OSError, SyntaxError):
        return None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _call_name(call: ast.Call) -> str:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------
def providers(dispatch_path: Path) -> Dict[str, Tuple[str, ...]]:
    """The ``_PROVIDERS`` tier -> module-names literal from dispatch.py."""
    tree = _parse(dispatch_path)
    if tree is None:
        return {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_PROVIDERS"
                and isinstance(node.value, ast.Dict)):
            continue
        out: Dict[str, Tuple[str, ...]] = {}
        for k, v in zip(node.value.keys, node.value.values):
            tier = _const_str(k) if k is not None else None
            if tier is None or not isinstance(v, (ast.Tuple, ast.List)):
                continue
            mods = [_const_str(e) for e in v.elts]
            out[tier] = tuple(m for m in mods if m)
        return out
    return {}


def registrations(path: Path) -> Tuple[Set[str], Set[Tuple[str, str, str]]]:
    """``(formats, impls)`` registered by one provider module.

    ``formats`` are ``register_format`` names; ``impls`` are
    ``(fmt, op, tier)`` triples from direct ``register_impl`` calls and
    from the ``for _fmt, ... in ((...), ...)`` registration loops."""
    formats: Set[str] = set()
    impls: Set[Tuple[str, str, str]] = set()
    tree = _parse(path)
    if tree is None:
        return formats, impls

    def impl_call(call: ast.Call, fmt_var: Optional[str]) -> None:
        if _call_name(call) != "register_impl" or len(call.args) < 3:
            return
        op = _const_str(call.args[1])
        if op is None:
            return
        tier = "reference"
        for kw in call.keywords:
            if kw.arg == "tier":
                tier = _const_str(kw.value) or tier
        fmt = _const_str(call.args[0])
        if fmt is not None:
            impls.add((fmt, op, tier))
        elif (fmt_var is not None and isinstance(call.args[0], ast.Name)
              and call.args[0].id == fmt_var):
            impls.add(("<loop>", op, tier))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            if _call_name(node) == "register_format" and node.args:
                name = _const_str(node.args[0])
                if name:
                    formats.add(name)
            impl_call(node, None)
        if not (isinstance(node, ast.For)
                and isinstance(node.target, ast.Tuple)
                and node.target.elts
                and isinstance(node.target.elts[0], ast.Name)
                and isinstance(node.iter, (ast.Tuple, ast.List))):
            continue
        fmt_var = node.target.elts[0].id
        fmts = []
        for elt in node.iter.elts:
            if isinstance(elt, (ast.Tuple, ast.List)) and elt.elts:
                fmt = _const_str(elt.elts[0])
                if fmt:
                    fmts.append(fmt)
        loop_impls: Set[Tuple[str, str]] = set()
        for inner in ast.walk(node):
            if isinstance(inner, ast.Call):
                before = {i for i in impls if i[0] == "<loop>"}
                impl_call(inner, fmt_var)
                for placeholder in {i for i in impls
                                    if i[0] == "<loop>"} - before:
                    loop_impls.add(placeholder[1:])
        impls = {i for i in impls if i[0] != "<loop>"}
        for fmt in fmts:
            for op, tier in loop_impls:
                impls.add((fmt, op, tier))
    return formats, impls


def dict_literal_keys(path: Path, name: str) -> Optional[Set[str]]:
    """String keys of a module-level ``name = { ... }`` assignment."""
    tree = _parse(path)
    if tree is None:
        return None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name
                and isinstance(node.value, ast.Dict)):
            keys = {_const_str(k) for k in node.value.keys
                    if k is not None}
            return {k for k in keys if k}
    return None


def tuple_literal(path: Path, name: str) -> Optional[Tuple[str, ...]]:
    """Elements of a module-level ``name = ("a", "b", ...)`` assignment."""
    tree = _parse(path)
    if tree is None:
        return None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name
                and isinstance(node.value, (ast.Tuple, ast.List))):
            elts = [_const_str(e) for e in node.value.elts]
            return tuple(e for e in elts if e)
    return None


def emitted_telemetry(src: Path) -> Dict[str, List[str]]:
    """Dotted names passed to ``.counter/.gauge/.histogram/.event/.span``
    anywhere under ``src`` (the package directory) -> the files that emit
    them."""
    out: Dict[str, List[str]] = {}
    for path in sorted(src.rglob("*.py")):
        tree = _parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TEL_METHODS and node.args):
                continue
            name = _const_str(node.args[0])
            if name and "." in name:
                out.setdefault(name, []).append(str(path))
    return out


def documented_telemetry(doc_path: Path) -> Optional[Set[str]]:
    """Dotted names from the first cell of the vocabulary tables in the
    '## Event vocabulary' section of docs/observability.md."""
    try:
        text = doc_path.read_text(encoding="utf-8")
    except OSError:
        return None
    names: Set[str] = set()
    in_section = False
    for line in text.splitlines():
        if line.startswith("## "):
            in_section = line.strip() == "## Event vocabulary"
            continue
        if not in_section or not line.startswith("|"):
            continue
        first_cell = line.split("|")[1] if line.count("|") >= 2 else ""
        names.update(_DOTTED.findall(first_cell))
    return names


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------
def audit(src: str = "src",
          docs: str = "docs/observability.md") -> List[Finding]:
    root = Path(src)
    findings: List[Finding] = []

    def err(rule: str, where: str, msg: str) -> None:
        findings.append(Finding(rule, ERROR, msg, where=where))

    def warn(rule: str, where: str, msg: str) -> None:
        findings.append(Finding(rule, WARN, msg, where=where))

    pkg = root / PACKAGE
    dispatch_path = pkg / "core" / "dispatch.py"
    provs = providers(dispatch_path)
    if not provs:
        err("RPR001", str(dispatch_path),
            "could not extract _PROVIDERS — the audit has no registry "
            "to check")
        return findings

    formats: Set[str] = set()
    impls: Set[Tuple[str, str, str]] = set()
    for tier, mods in provs.items():
        for mod in mods:
            path = root / Path(*mod.split(".")).with_suffix(".py")
            if not path.is_file():
                err("RPR001", str(dispatch_path),
                    f"_PROVIDERS[{tier!r}] names {mod!r} but "
                    f"{path} does not exist")
                continue
            f, i = registrations(path)
            formats |= f
            impls |= i

    dispatch_src = str(dispatch_path)

    # RPR001: registered formats have both reference ops
    for fmt in sorted(formats):
        for op in ("spmv", "spmm"):
            if (fmt, op, "reference") not in impls:
                err("RPR001", dispatch_src,
                    f"format {fmt!r} is registered but has no "
                    f"reference-tier {op} implementation")

    # RPR004: impls belong to registered formats
    for fmt in sorted({f for (f, _, _) in impls}):
        if fmt not in formats:
            err("RPR004", dispatch_src,
                f"implementations registered for {fmt!r} but no "
                f"register_format call maps a container class to it")

    # RPR002: kernel tier <-> tuner grid surface
    kt_path = pkg / "core" / "kernel_tune.py"
    grid = tuple_literal(kt_path, "GRID_FORMATS")
    if grid is None:
        err("RPR002", str(kt_path),
            "could not extract GRID_FORMATS — the kernel tier cannot be "
            "checked against the tuner's grid surface")
    else:
        kernel_fmts = {f for (f, _, t) in impls if t == "kernel"}
        for fmt in sorted(kernel_fmts):
            # hybrid has no grid of its own: it composes its blocks'
            # tuned geometries
            if fmt not in grid and fmt != "hybrid":
                err("RPR002", str(kt_path),
                    f"kernel-tier {fmt!r} has no candidate grid in "
                    f"GRID_FORMATS — the tuner would always serve it "
                    f"default geometry")
        for fmt in grid:
            if fmt not in kernel_fmts:
                warn("RPR002", str(kt_path),
                     f"GRID_FORMATS lists {fmt!r} but no kernel-tier "
                     f"implementation is registered (stale grid entry)")

    # RPR003: reference spmv <-> host transform recipes
    tr_path = pkg / "core" / "transform.py"
    recipes = dict_literal_keys(tr_path, "TRANSFORMS_HOST")
    if recipes is None:
        err("RPR003", str(tr_path),
            "could not extract TRANSFORMS_HOST — transform coverage "
            "cannot be checked")
    else:
        ref_spmv = {f for (f, op, t) in impls
                    if op == "spmv" and t == "reference"}
        for fmt in sorted(ref_spmv):
            if fmt not in recipes:
                err("RPR003", str(tr_path),
                    f"format {fmt!r} is servable but TRANSFORMS_HOST has "
                    f"no CRS->{fmt} recipe — the planner cannot reach it")
        for fmt in sorted(recipes):
            if fmt not in ref_spmv:
                warn("RPR003", str(tr_path),
                     f"TRANSFORMS_HOST recipe {fmt!r} has no reference "
                     f"spmv implementation")

    # RPR005: telemetry vocabulary
    doc_path = Path(docs)
    documented = documented_telemetry(doc_path)
    if documented is None:
        err("RPR005", str(doc_path),
            "could not read the telemetry vocabulary")
        return findings
    emitted = emitted_telemetry(pkg)
    for name in sorted(emitted):
        if name not in documented:
            err("RPR005", emitted[name][0],
                f"telemetry name {name!r} is emitted but missing from "
                f"the vocabulary in {doc_path}")
    for name in sorted(documented):
        if name not in emitted:
            warn("RPR005", str(doc_path),
                 f"telemetry name {name!r} is documented but nothing in "
                 f"{pkg} emits it")
    return findings


__all__ = ["audit", "providers", "registrations", "dict_literal_keys",
           "tuple_literal", "emitted_telemetry", "documented_telemetry"]
