"""AST lint for repo-specific reliability rules (RPA0xx), for the port.

Generic linters do not know this codebase's contracts: errors swallowed on
the serving path must be *counted* (``service.swallowed_errors``),
serve-side time must come through the injectable clock so deadline tests
stay deterministic, ``repro_torch.obs`` and ``repro_torch.analyze`` import
no array framework, the port imports neither JAX nor the JAX package, and
any wall-clock measurement of CUDA work that does not wait for the card
times the launch instead of the kernel — the trap the paper's
``t_f``/``t_crs`` methodology exists to avoid.  This pass encodes those
contracts.

Rules:

  RPA001  bare/blind ``except`` whose handler neither re-raises nor
          accounts for the error (a counter ``.inc()``, a call whose
          name mentions swallow/fail, or an assignment to an
          error-named binding)
  RPA002  direct ``time.time()`` / ``perf_counter()`` / ``monotonic()``
          *calls* in ``serve/`` — referencing them as injectable-clock
          defaults is fine; calling them bypasses the injected clock
  RPA003  a ``torch`` / ``jax`` / ``triton`` import inside a declared
          framework-free package (``repro_torch/obs``,
          ``repro_torch/analyze``, ``repro_torch/launch_shapes.py``), and a
          ``jax`` or ``repro`` import
          anywhere under ``repro_torch/`` (the port runs without both)
  RPA004  a function that samples the clock twice around torch work
          with no ``torch.cuda.synchronize()``, ``Event.synchronize()``
          or ``.item()`` in sight
  RPA005  mutable default arguments

Waivers: ``# repro: noqa[RPA001]`` (or bare ``# repro: noqa``) on the
flagged line or the line above suppresses the finding.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

from .findings import ERROR, Finding

#: packages (and the one module) that import no array framework (enforced
#: mechanically; their docstrings declare it)
FRAMEWORK_FREE_PACKAGES = ("repro_torch/obs", "repro_torch/analyze",
                           "repro_torch/launch_shapes.py")
#: what those packages may not import
FRAMEWORKS = ("torch", "jax", "triton")
#: what nothing under ``repro_torch/`` may import: JAX and the JAX package
FOREIGN = ("jax", "repro")

_NOQA = re.compile(r"#.*?repro:\s*noqa(?:\[([A-Za-z0-9, ]+)\])?")
_TIME_ATTRS = {"time", "perf_counter", "perf_counter_ns", "monotonic",
               "monotonic_ns", "process_time"}
_TIME_NAMES = {"perf_counter", "perf_counter_ns", "monotonic",
               "monotonic_ns"}
_ERRORISH = ("error", "err", "drop", "swallow", "fail")


def _waivers(source: str) -> Dict[int, Optional[Set[str]]]:
    """line -> waived rule set (None = all rules) from noqa comments."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _NOQA.search(line)
        if not m:
            continue
        if m.group(1) is None:
            out[i] = None
        else:
            out[i] = {r.strip().upper() for r in m.group(1).split(",")}
    return out


def _waived(waivers: Dict[int, Optional[Set[str]]], rule: str,
            line: int) -> bool:
    for ln in (line, line - 1):
        if ln in waivers:
            rules = waivers[ln]
            if rules is None or rule in rules:
                return True
    return False


def _call_name(call: ast.Call) -> str:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _is_timing_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
            and fn.value.id == "time" and fn.attr in _TIME_ATTRS):
        return True
    return isinstance(fn, ast.Name) and fn.id in _TIME_NAMES


def _is_blind_except(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(isinstance(n, ast.Name)
               and n.id in ("Exception", "BaseException") for n in names)


def _accounts_error(handler: ast.ExceptHandler) -> bool:
    """Does the handler body visibly re-raise or account for the error?"""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = _call_name(node).lower()
            if name == "inc" or "swallow" in name or "fail" in name:
                return True
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                tname = ""
                if isinstance(tgt, ast.Name):
                    tname = tgt.id
                elif isinstance(tgt, ast.Attribute):
                    tname = tgt.attr
                if any(tok in tname.lower() for tok in _ERRORISH):
                    return True
    return False


def _imported(node: ast.AST, roots) -> Optional[str]:
    """The module an import statement names, if its top-level package is
    one of ``roots`` (relative imports name none)."""
    names = []
    if isinstance(node, ast.Import):
        names = [alias.name for alias in node.names]
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
        names = [node.module]
    for name in names:
        if name.split(".")[0] in roots:
            return name
    return None


def _references_torch(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == "torch":
            return True
    return False


def _waits_for_card(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and _call_name(node) in ("synchronize", "item"):
            return True
    return False


# ---------------------------------------------------------------------------
# per-file lint
# ---------------------------------------------------------------------------
def lint_source(source: str, path: str = "<input>") -> List[Finding]:
    findings: List[Finding] = []
    try:
        tree = ast.parse(source, path)
    except SyntaxError as e:
        return [Finding("RPA000", ERROR, f"does not parse: {e.msg}",
                        where=path, line=e.lineno or 0)]
    waivers = _waivers(source)
    posix = Path(path).as_posix()
    in_serve = "/serve/" in posix or posix.startswith("serve/")
    framework_free = any(pkg in posix for pkg in FRAMEWORK_FREE_PACKAGES)
    in_port = "repro_torch/" in posix or posix.startswith("repro_torch")

    def add(rule: str, line: int, msg: str) -> None:
        if not _waived(waivers, rule, line):
            findings.append(Finding(rule, ERROR, msg, where=path,
                                    line=line))

    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and _is_blind_except(node):
            if not _accounts_error(node):
                add("RPA001", node.lineno,
                    "blind except swallows the error without re-raising "
                    "or accounting for it (counter .inc(), a "
                    "swallow/fail helper, or an error-named binding)")
        if in_serve and _is_timing_call(node):
            add("RPA002", node.lineno,
                "direct clock call on the serving path — route time "
                "through the injectable clock (SpMVService(clock=...)) "
                "so deadline logic stays testable")
        if framework_free:
            mod = _imported(node, FRAMEWORKS)
            if mod is not None:
                add("RPA003", node.lineno,
                    f"import of {mod!r} inside a declared framework-free "
                    f"package ({', '.join(FRAMEWORK_FREE_PACKAGES)})")
        if in_port:
            mod = _imported(node, FOREIGN)
            if mod is not None:
                add("RPA003", node.lineno,
                    f"import of {mod!r} inside the port: repro_torch runs "
                    f"without JAX and without the JAX package")
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            samples = sum(1 for n in ast.walk(node) if _is_timing_call(n))
            if (samples >= 2 and _references_torch(node)
                    and not _waits_for_card(node)):
                add("RPA004", node.lineno,
                    f"{node.name!r} samples the clock {samples}x around "
                    f"torch work without torch.cuda.synchronize(), "
                    f"Event.synchronize() or .item() — it times the "
                    f"launch, not the kernel")
            for default in [*node.args.defaults,
                            *node.args.kw_defaults]:
                if default is None:
                    continue
                mutable = isinstance(default,
                                     (ast.List, ast.Dict, ast.Set))
                if (isinstance(default, ast.Call)
                        and isinstance(default.func, ast.Name)
                        and default.func.id in ("list", "dict", "set")):
                    mutable = True
                if mutable:
                    add("RPA005", default.lineno,
                        f"mutable default argument in {node.name!r} is "
                        f"shared across calls — default to None and "
                        f"materialize inside")
    findings.sort(key=lambda f: (f.line, f.rule))
    return findings


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """Lint ``.py`` files and directories (recursively)."""
    findings: List[Finding] = []
    for p in paths:
        path = Path(p)
        files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
        for f in files:
            try:
                source = f.read_text(encoding="utf-8")
            except OSError as e:
                findings.append(Finding("RPA000", ERROR,
                                        f"unreadable: {e}", where=str(f)))
                continue
            findings.extend(lint_source(source, str(f)))
    return findings


__all__ = ["FRAMEWORK_FREE_PACKAGES", "FRAMEWORKS", "FOREIGN",
           "lint_source", "lint_paths"]
