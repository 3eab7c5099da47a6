"""``python -m repro_torch.obs`` — inspect telemetry streams and saved plans.

Subcommands (all pure-stdlib; none import an array framework, so the CLI is fast and
usable on machines without the accelerator stack):

* ``summarize <events.jsonl>`` — per-span latency percentiles, the
  decision table (which rule fired, where on the D_mat axis), tune
  winners, offline t_trans/t_crs/t_f measurements, and serving flush /
  plan-replay counts from one JSONL event stream.
* ``validate <trace.json>`` — Chrome-trace schema check; exit code 1 on
  violations (what CI runs on the quickstart trace artifact).
* ``plan <plan.json>`` — pretty-print a saved ``ExecutionPlan`` (the
  ROADMAP's plan-inspection CLI).
* ``diff <a.json> <b.json>`` — field-by-field diff of two plans; exit
  code 1 when they differ.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .export import read_jsonl, validate_chrome_trace
from .telemetry import percentile


def _table(headers: Sequence[str], rows: Iterable[Sequence[Any]],
           out) -> None:
    rows = [[str(c) for c in r] for r in rows]
    widths = [max([len(h)] + [len(r[i]) for r in rows])
              for i, h in enumerate(headers)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    print(fmt.format(*headers), file=out)
    print(fmt.format(*("-" * w for w in widths)), file=out)
    for r in rows:
        print(fmt.format(*r), file=out)


def _us(seconds: float) -> str:
    return f"{seconds * 1e6:.1f}"


def _attr(rec: Dict[str, Any], key: str, default: Any = "") -> Any:
    return (rec.get("attrs") or {}).get(key, default)


# ---------------------------------------------------------------------------
# summarize
# ---------------------------------------------------------------------------
def summarize(path: str, out=None) -> int:
    out = out or sys.stdout
    records = read_jsonl(path)
    spans = [r for r in records if r.get("type") == "span"]
    events = [r for r in records if r.get("type") == "event"]
    print(f"{path}: {len(spans)} spans, {len(events)} events", file=out)

    # -- span latency percentiles -------------------------------------------
    by_name: Dict[str, List[float]] = defaultdict(list)
    for s in spans:
        key = s["name"]
        fmt = _attr(s, "fmt")
        if fmt:
            key = f"{s['name']}[{fmt}]"
        by_name[key].append(float(s.get("dur", 0.0)))
    if by_name:
        print("\n== span latency (us) ==", file=out)
        _table(
            ("span", "count", "total_ms", "p50", "p90", "p99", "max"),
            [(name, len(ds), f"{sum(ds) * 1e3:.2f}",
              _us(percentile(ds, 0.50)), _us(percentile(ds, 0.90)),
              _us(percentile(ds, 0.99)), _us(max(ds)))
             for name, ds in sorted(by_name.items())], out)

    # -- decision table (the replayable D_mat–R points) ---------------------
    decisions = [e for e in events if e["name"] == "plan.decision"]
    if decisions:
        groups: Dict[Tuple[str, str], List[Dict]] = defaultdict(list)
        for e in decisions:
            groups[(str(_attr(e, "rule")), str(_attr(e, "fmt")))].append(e)
        print("\n== plan decisions ==", file=out)
        _table(
            ("rule", "fmt", "count", "d_mat_min", "d_mat_max", "d_star"),
            [(rule, fmt, len(es),
              f"{min(float(_attr(e, 'd_mat', 0) or 0) for e in es):.3f}",
              f"{max(float(_attr(e, 'd_mat', 0) or 0) for e in es):.3f}",
              _fmt_opt(_attr(es[-1], "d_star", None)))
             for (rule, fmt), es in sorted(groups.items())], out)

    # -- offline measurements (paper quantities) ----------------------------
    measures = [e for e in events if e["name"] == "offline.measure"]
    if measures:
        print("\n== offline measurements (t in us) ==", file=out)
        _table(
            ("matrix", "fmt", "batch", "t_crs", "t_f", "t_trans", "r"),
            [(_attr(e, "matrix"), _attr(e, "fmt"), _attr(e, "batch", 1),
              _us(float(_attr(e, "t_crs", 0))),
              _us(float(_attr(e, "t_f", 0))),
              _us(float(_attr(e, "t_trans", 0))),
              f"{float(_attr(e, 'r', 0)):.3f}")
             for e in measures], out)

    # -- tune winners -------------------------------------------------------
    winners = [e for e in events if e["name"] == "tune.winner"]
    if winners:
        print("\n== tune winners ==", file=out)
        _table(
            ("fmt", "op", "batch", "t_best_us", "t_default_us", "speedup",
             "geometry"),
            [(_attr(e, "fmt"), _attr(e, "op"), _attr(e, "batch", 1),
              _us(float(_attr(e, "t_best", 0))),
              _us(float(_attr(e, "t_default", 0))),
              f"{float(_attr(e, 'speedup', 1)):.2f}x",
              json.dumps(_attr(e, "geometry", {})))
             for e in winners], out)

    # -- serving ------------------------------------------------------------
    flushes = [e for e in events if e["name"] == "service.flush"]
    if flushes:
        causes: Dict[str, int] = defaultdict(int)
        vectors: Dict[str, int] = defaultdict(int)
        for e in flushes:
            causes[str(_attr(e, "cause"))] += 1
            vectors[str(_attr(e, "cause"))] += int(_attr(e, "batch", 0) or 0)
        print("\n== service flushes ==", file=out)
        _table(("cause", "flushes", "vectors"),
               [(c, causes[c], vectors[c]) for c in sorted(causes)], out)
    replays = [e for e in events if e["name"] == "service.plan_replay"]
    if replays:
        hits = sum(1 for e in replays if _attr(e, "hit"))
        print(f"\nplan replays: {hits} hit / {len(replays) - hits} miss",
              file=out)
    return 0


def _fmt_opt(v: Any) -> str:
    if v is None or v == "":
        return "-"
    try:
        return f"{float(v):.3f}"
    except (TypeError, ValueError):
        return str(v)


# ---------------------------------------------------------------------------
# validate
# ---------------------------------------------------------------------------
def validate(path: str, out=None) -> int:
    out = out or sys.stdout
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            print(f"{path}: not valid JSON: {e}", file=out)
            return 1
    errors = validate_chrome_trace(obj)
    if errors:
        for e in errors:
            print(f"{path}: {e}", file=out)
        return 1
    n = len(obj["traceEvents"])
    print(f"{path}: valid Chrome trace ({n} events)", file=out)
    return 0


# ---------------------------------------------------------------------------
# plan pretty-print + diff (raw JSON — no array-framework import)
# ---------------------------------------------------------------------------
def _load_plan(path: str) -> Dict[str, Any]:
    with open(path) as f:
        obj = json.load(f)
    if not isinstance(obj, dict) or "fmt" not in obj:
        raise ValueError(f"{path}: not an ExecutionPlan JSON "
                         "(missing 'fmt')")
    return obj


def show_plan(path: str, out=None) -> int:
    out = out or sys.stdout
    p = _load_plan(path)
    print(f"ExecutionPlan (schema v{p.get('schema_version', '?')}) "
          f"— {path}", file=out)
    for k in ("fmt", "rule", "tier", "batch", "expected_iterations",
              "machine", "d_mat", "d_star", "expected_gain"):
        if k in p:
            print(f"  {k:<20} {p[k]}", file=out)
    tr = p.get("transform") or {}
    print(f"  {'transform':<20} {tr.get('name')} "
          f"{json.dumps(tr.get('params', {}))}", file=out)
    for op, g in (p.get("geometry") or {}).items():
        print(f"  {'geometry.' + op:<20} {json.dumps(g)}", file=out)
    fp = p.get("fingerprint")
    if fp:
        print(f"  {'fingerprint':<20} n={fp.get('n')} nnz={fp.get('nnz')} "
              f"d_mat={fp.get('d_mat')} sig={fp.get('sig')}", file=out)
    blocks = p.get("blocks")
    if blocks:
        print(f"  blocks ({len(blocks)}):", file=out)
        _table(("rows", "fmt", "rule", "d_mat", "geometry"),
               [(f"{b['rows'][0]}:{b['rows'][1]}", b["plan"].get("fmt"),
                 b["plan"].get("rule"),
                 _fmt_opt(b["plan"].get("d_mat")),
                 json.dumps(b["plan"].get("geometry", {})))
                for b in blocks], out)
    return 0


def _flatten(obj: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(_flatten(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = obj
    return out


def diff_plans(path_a: str, path_b: str, out=None) -> int:
    out = out or sys.stdout
    fa, fb = _flatten(_load_plan(path_a)), _flatten(_load_plan(path_b))
    keys = sorted(set(fa) | set(fb))
    rows = []
    for k in keys:
        va = fa.get(k, "<absent>")
        vb = fb.get(k, "<absent>")
        if va != vb:
            rows.append((k, va, vb))
    if not rows:
        print(f"plans identical ({len(keys)} fields)", file=out)
        return 0
    print(f"{len(rows)} of {len(keys)} fields differ:", file=out)
    _table(("field", path_a, path_b), rows, out)
    return 1


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize telemetry streams; inspect/diff saved "
                    "ExecutionPlan JSON.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("summarize", help="summarize a telemetry JSONL") \
        .add_argument("path")
    sub.add_parser("validate", help="validate a Chrome trace JSON") \
        .add_argument("path")
    sub.add_parser("plan", help="pretty-print an ExecutionPlan JSON") \
        .add_argument("path")
    d = sub.add_parser("diff", help="diff two ExecutionPlan JSON files")
    d.add_argument("path_a")
    d.add_argument("path_b")
    args = ap.parse_args(argv)
    if args.cmd == "summarize":
        return summarize(args.path)
    if args.cmd == "validate":
        return validate(args.path)
    if args.cmd == "plan":
        return show_plan(args.path)
    return diff_plans(args.path_a, args.path_b)


__all__ = ["main", "summarize", "validate", "show_plan", "diff_plans"]
