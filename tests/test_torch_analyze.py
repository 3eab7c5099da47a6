"""Port vs reference: the static-analysis subsystem (``repro_torch.analyze``).

Mirrors ``tests/test_analyze.py``: plan lint over crafted bad artifacts, the
registry audit run against the real tree, the AST rules and their
``# repro: noqa`` waivers, the CLI exit codes (proven torch-free in a
subprocess), and the three integration points — PlanStore quarantine with
reason ``lint``, ``register(strict_lint=)``, and the Planner's mint-time
self-check.  Where a rule is shared (RPL001, RPL003, RPL005-RPL010, the AST
rules), the port's findings are held against ``repro.analyze``'s on the
same payload.  RPL002 and RPL004 describe the launch, so their cases are
re-expressed for the Hopper rules: no 8-alignment rule (a CUDA block takes
any whole number of rows; the tuner's grid holds tiles of 1, 2 and 4), an
error exactly where the launch helpers (``repro_torch.launch_shapes``,
re-exported by ``kernels/_common.py``) reject, a warning where they clamp,
and shared memory a block against the H100's 226 KiB.
"""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analyze import lint_plan as ref_lint_plan
from repro.analyze import lint_source as ref_lint_source
from repro_torch.analyze import (PlanLintError, errors, has_errors,
                                 lint_plan, lint_source, lint_text)
from repro_torch.analyze import planlint as PL
from repro_torch.analyze import registry as reg
from repro_torch.analyze.cli import main as analyze_main
from repro_torch.core import kernel_tune as KT
from repro_torch.kernels import _common as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "plan_good.json")
SRC = os.path.join(REPO, "src")
DOCS = os.path.join(REPO, "docs", "observability.md")


def rules(findings, severity=None):
    return {f.rule for f in findings
            if severity is None or f.severity == severity}


@pytest.fixture()
def good():
    with open(FIXTURE) as f:
        payload = json.load(f)
    return copy.deepcopy(payload)


# ---------------------------------------------------------------------------
# plan lint (RPL): the Hopper rules
# ---------------------------------------------------------------------------
def test_good_fixture_is_clean(good):
    """No error in either package.  The port warns once: the fixture's
    SpMM tile (256 rows at block_k=8, so 8 lanes a row) asks for 2048
    threads and ``clamp_threads`` gives the block 1024."""
    assert ref_lint_plan(good) == []
    found = lint_plan(good)
    assert not has_errors(found)
    assert [(f.rule, f.severity, f.where) for f in found] == \
        [("RPL002", "warn", "geometry.spmm")]
    assert C.rows_per_block(8, 256) == 128


def test_misaligned_block_rows(good):
    """The reference errors on a tile that is not 8-aligned (a TPU lane
    rule); a CUDA block takes any whole number of rows, so the port does
    not — its errors are an unknown knob, a value that is not a positive
    integer, and what ``_common.py`` rejects."""
    good["geometry"]["spmv"]["block_rows"] = 100
    assert "RPL002" in rules(ref_lint_plan(good), "error")
    assert "RPL002" not in rules(lint_plan(good), "error")
    for bad in (0, -4, 2.5, "256", True):
        g = copy.deepcopy(good)
        g["geometry"]["spmv"]["block_rows"] = bad
        assert "RPL002" in rules(lint_plan(g), "error"), bad
    good["geometry"]["spmv"]["warps"] = 4
    assert "RPL002" in rules(lint_plan(good), "error")


def test_slab_bound_below_structure(good):
    # n=1024, nnz=16384, block_rows=256 -> 4 segments; block_nnz=2048
    # -> ceil(16384 / (4 * 2048)) = 2 slabs needed, 1 recorded
    good["geometry"]["spmv"]["slabs_per_block"] = 1
    found = lint_plan(good)
    assert "RPL003" in rules(found, "error")
    assert any("slabs_per_block=1" in f.message for f in errors(found))
    assert rules(found, "error") == rules(ref_lint_plan(good), "error")


def _wide_csr(good):
    """The fixture at B = 128: its SpMM launches K5's window kernel, whose
    window takes a third of an SM's shared memory."""
    good["batch"] = 128
    good["geometry"]["spmm"] = {"block_rows": 32, "block_k": 128}
    return good


def test_smem_over_budget_and_override(good):
    good = _wide_csr(good)
    assert "RPL004" not in rules(lint_plan(good))      # fits an H100
    found = lint_plan(good, smem_budget=64 * 1024)     # a 64 KiB part
    assert "RPL004" in rules(found, "error")
    assert any("KiB" in f.message for f in errors(found))


def test_smem_only_applies_to_kernel_tier(good):
    good = _wide_csr(good)
    good["tier"] = "reference"
    assert "RPL004" not in rules(lint_plan(good, smem_budget=64 * 1024))


def test_footprint_counts_the_knob_driven_launches():
    """The model's shared memory is the launches' own: COO's staged pass
    (``coo_launch``), K10's slice ring (``bcsr_spmm_launch``)."""
    for bn in (256, 1024, 4096, 16384, 1 << 20):
        threads, _, chunk = C.coo_launch(bn)
        assert PL._footprint({"block_nnz": bn}, "coo_row", "spmv", {}, 1) \
            == (threads, threads * chunk * 8)
    for b in (4, 8, 16):
        for rows in (1, 2, 8, 16):
            kt, threads, _, slots, stride = C.bcsr_spmm_launch(
                128, b, block_rows=rows)
            want = slots * (b * stride + b * b * 4)
            got = PL._footprint({"block_rows": rows, "block_k": 128},
                                "bcsr", "spmm", {"block": b}, 128)
            assert got == (threads, want), (b, rows)
            assert want <= C.SMEM_BLOCK_MAX


_SHARED = {
    "missing_required_fields": (
        lambda g: g.pop("transform"), "RPL001", "error"),
    "unknown_format": (
        lambda g: g.update(fmt="quantum_csr"), "RPL001", "error"),
    "transform_cannot_produce_fmt": (
        lambda g: g["transform"].update(name="sell"), "RPL008", "error"),
    "fingerprint_nonsense": (
        lambda g: g["fingerprint"].update(n=0), "RPL009", "error"),
    "fingerprint_mu_drift_warns": (
        lambda g: g["fingerprint"].update(mu=99.0), "RPL009", "warn"),
}


@pytest.mark.parametrize("case", sorted(_SHARED))
def test_shared_rules_match_reference(good, case):
    mutate, rule, severity = _SHARED[case]
    mutate(good)
    found = lint_plan(good)
    assert rule in rules(found, severity)
    assert rules(found, "error") == rules(ref_lint_plan(good), "error")
    if severity == "warn":
        assert not has_errors(found)


def _sell_plan():
    return {
        "schema_version": 1, "fmt": "sell", "rule": "paper",
        "tier": "kernel", "batch": 1, "expected_iterations": 100,
        "transform": {"name": "sell",
                      "params": {"slice_rows": 64, "width_quantum": 8}},
        "geometry": {"spmv": {
            "block_rows": 256, "block_w": 128,
            "buckets": [[32, {"block_rows": 256, "block_w": 32}],
                        [8, {"block_rows": 256, "block_w": 8}]]}},
        "machine": "", "d_mat": 0.25, "d_star": None,
        "expected_gain": 0.0,
        "fingerprint": {"n": 1024, "nnz": 16384, "mu": 16.0,
                        "sigma": 4.0, "d_mat": 0.25, "sig": 7},
        "blocks": None,
    }


def _leaf(n, nnz):
    return {
        "schema_version": 1, "fmt": "ell_row", "rule": "cost_model",
        "tier": "reference", "batch": 1, "expected_iterations": 100,
        "transform": {"name": "ell_row", "params": {}}, "geometry": {},
        "machine": "", "d_mat": None, "d_star": None,
        "expected_gain": 0.0,
        "fingerprint": {"n": n, "nnz": nnz, "mu": None, "sigma": None,
                        "d_mat": None, "sig": 1},
        "blocks": None,
    }


def _hybrid_plan():
    return {
        "schema_version": 1, "fmt": "hybrid", "rule": "cost_model",
        "tier": "reference", "batch": 1, "expected_iterations": 100,
        "transform": {"name": "hybrid", "params": {}}, "geometry": {},
        "machine": "", "d_mat": None, "d_star": None,
        "expected_gain": 0.0,
        "fingerprint": {"n": 96, "nnz": 600, "mu": None, "sigma": None,
                        "d_mat": None, "sig": 2},
        "blocks": [{"rows": [0, 64], "plan": _leaf(64, 400)},
                   {"rows": [64, 96], "plan": _leaf(32, 200)}],
    }


def _sharded_plan():
    return {
        "kind": "sharded_plan", "schema_version": 1, "axis": "row",
        "strategy": "balanced_nnz", "params": {}, "mesh_shape": [2],
        "mesh_axis": "shards", "batch": 1,
        "fingerprint": {"n": 128, "nnz": 900, "mu": None, "sigma": None,
                        "d_mat": None, "sig": 3},
        "shards": [{"rows": [0, 64], "plan": _leaf(64, 500)},
                   {"rows": [64, 128], "plan": _leaf(64, 400)}],
    }


def _set(path, value):
    def mutate(d):
        obj = d
        for k in path[:-1]:
            obj = obj[k]
        obj[path[-1]] = value
    return mutate


#: (payload, mutation, rule the port must report as an error or None)
_PAYLOADS = {
    "sell_plan_is_clean": (_sell_plan, None, None),
    "sell_bucket_width_off_quantum": (
        _sell_plan, _set(("geometry", "spmv", "buckets", 0, 0), 12),
        "RPL005"),
    "sell_too_many_buckets": (
        _sell_plan, _set(("transform", "params", "slice_rows"), 1024),
        "RPL005"),
    "hybrid_plan_is_clean": (_hybrid_plan, None, None),
    "hybrid_blocks_must_tile_from_zero": (
        _hybrid_plan, _set(("blocks", 0, "rows"), [8, 64]), "RPL006"),
    "hybrid_nnz_must_sum": (
        _hybrid_plan, _set(("blocks", 1, "plan", "fingerprint", "nnz"), 150),
        "RPL006"),
    "sharded_plan_is_clean": (_sharded_plan, None, None),
    "sharded_spans_must_cover_rows": (
        _sharded_plan, _set(("shards", 1, "rows"), [64, 100]), "RPL007"),
    "sharded_shard_fingerprint_required": (
        _sharded_plan, _set(("shards", 0, "plan", "fingerprint"), None),
        "RPL007"),
}


@pytest.mark.parametrize("case", sorted(_PAYLOADS))
def test_container_plans_match_reference(case):
    make, mutate, rule = _PAYLOADS[case]
    d = make()
    if mutate is not None:
        mutate(d)
    found = lint_plan(d)
    if rule is None:
        assert not has_errors(found)
    else:
        assert rule in rules(found, "error")
    assert rules(found, "error") == rules(ref_lint_plan(d), "error")


def test_envelope_checksum(good):
    import hashlib
    canonical = json.dumps(good, sort_keys=True, separators=(",", ":"))
    env = {"store_version": 1,
           "sha256": hashlib.sha256(canonical.encode()).hexdigest(),
           "plan": good}
    assert not has_errors(lint_text(json.dumps(env)))
    env["plan"]["batch"] = 16             # tamper without re-signing
    found = lint_text(json.dumps(env))
    assert has_errors(found)
    assert any("sha256" in f.message for f in errors(found))


def test_not_json_is_one_error():
    found = lint_text("{not json")
    assert [f.rule for f in found] == ["RPL001"]


# ---------------------------------------------------------------------------
# the Hopper rules against the launch helpers
# ---------------------------------------------------------------------------
# a matrix the launches are shaped for (5000 rows and columns, 16 entries
# a row), to hold the footprint model against the launch it describes
_N, _NNZ = 5000, 80000


def _threads_window_csr(b, br, bk):
    return C.csr_spmm_launch(b, _N, _N, _NNZ, br, bk, window=True)[3]


# (fmt, op, knobs, batch, params) -> the (threads, knob-driven shared bytes)
# the wrappers' launch helpers give a CUDA block
_LAUNCHES = {
    "coo_spmv_small": ("coo_row", "spmv", {"block_nnz": 256}, 1, {},
                       lambda: (C.coo_launch(256)[0],
                                C.coo_launch(256)[0] * 4 * 8)),
    "coo_spmv_passes": ("coo_col", "spmv", {"block_nnz": 16384}, 1, {},
                        lambda: (C.coo_launch(16384)[0],
                                 C.coo_launch(16384)[0] * 8 * 8)),
    "csr_spmv": ("csr", "spmv", {"block_nnz": 4096}, 1, {},
                 lambda: (C.csr_slices(_NNZ, 4096)[0], 0)),
    "ccs_spmv_default": ("ccs", "spmv", {}, 1, {},
                         lambda: (C.ccs_spmv_launch(_N, _N, _NNZ)[0],
                                  C.CCS_SPMV_WARPS * C.CCS_SPMV_WINDOW_MAX
                                  * 17)),
    "ccs_spmv_two_warps": ("ccs", "spmv", {"block_rows": 2}, 1, {},
                           lambda: (64, 2 * C.CCS_SPMV_WINDOW_MAX * 17)),
    "bcsr_spmv": ("bcsr", "spmv", {"block_rows": 16}, 1, {"block": 4},
                  lambda: (C.bcsr_spmv_launch(4, 16)[0], 0)),
    "ell_spmv": ("ell_row", "spmv", {"block_rows": 96}, 1, {},
                 lambda: (C.rows_per_block(1, 96), 0)),
    "sell_spmv_default": ("sell", "spmv", {}, 1, {},
                          lambda: (C.DEFAULT_THREADS, 0)),
    "csr_spmm_window": ("csr", "spmm", {"block_rows": 32, "block_k": 128},
                        128, {}, lambda: (_threads_window_csr(128, 32, 128),
                                          C.SMEM_BLOCK_MAX
                                          // C.CSR_SPMM_BLOCKS_PER_SM)),
    "csr_spmm_window_default_rows": (
        "csr", "spmm", {"block_k": 64}, 64, {},
        lambda: (_threads_window_csr(64, None, 64),
                 C.SMEM_BLOCK_MAX // C.CSR_SPMM_BLOCKS_PER_SM)),
    "csr_spmm_row_groups": ("csr", "spmm", {"block_rows": 4, "block_k": 16},
                            16, {}, lambda: (C.csr_spmm_launch(
                                16, _N, _N, _NNZ, 4, 16)[3], 0)),
    "ccs_spmm_window": ("ccs", "spmm", {"block_rows": 32, "block_k": 128},
                        128, {}, lambda: (C.ccs_spmm_launch(
                            128, _N, _N, _NNZ, 32, 128)[3], 0)),
    "ccs_spmm_groups": ("ccs", "spmm", {"block_rows": 16, "block_k": 8}, 8,
                        {}, lambda: (C.ccs_spmm_launch(
                            8, _N, _N, _NNZ, 16, 8)[3], 0)),
    "coo_spmm": ("coo_row", "spmm", {"block_nnz": 96, "block_k": 32}, 32,
                 {}, lambda: (C.coo_spmm_groups(32, 96)[0], 0)),
    "ell_spmm": ("ell_col", "spmm", {"block_rows": 2, "block_k": 4}, 4, {},
                 lambda: (C.row_group_launch(4, 2, 4)[3]
                          * C.rhs_tile(4, 4)[1], 0)),
    "bcsr_spmm_rows": ("bcsr", "spmm", {"block_rows": 8, "block_k": 8}, 8,
                       {"block": 8},
                       lambda: (C.row_group_launch(8, 8, 8)[3]
                                * C.rhs_tile(8, 8)[1], 0)),
    "bcsr_spmm_ring_b16": (
        "bcsr", "spmm", {"block_rows": 16, "block_k": 128}, 128,
        {"block": 16},
        lambda: (C.bcsr_spmm_launch(128, 16, 16, 128)[1],
                 C.bcsr_spmm_launch(128, 16, 16, 128)[3]
                 * (16 * C.bcsr_spmm_launch(128, 16, 16, 128)[4]
                    + 16 * 16 * 4))),
    "bcsr_spmm_rejected": ("bcsr", "spmm", {"block_k": 1}, 10 ** 7,
                           {"block": 8}, lambda: None),
    "csr_spmm_rejected": ("csr", "spmm", {"block_k": 64}, 10 ** 8, {},
                          lambda: None),
    "no_cuda_launch": ("dense", "spmv", {}, 1, {}, lambda: None),
}


@pytest.mark.parametrize("case", sorted(_LAUNCHES))
def test_footprint_is_the_launch(case):
    """RPL004's model is the launch the wrapper makes: the threads its
    helper gives a block and the shared memory the knobs size (none where
    the helper rejects the launch, which RPL002 reports)."""
    fmt, op, knobs, batch, params, want = _LAUNCHES[case]
    assert PL._footprint(knobs, fmt, op, params, batch) == want()


def test_launch_shapes_is_torch_free_and_shared():
    """The launch arithmetic has one home, which imports no framework; the
    kernel wrappers and the plan lint both call it."""
    from repro_torch import launch_shapes as LS
    assert C.rhs_tile is LS.rhs_tile and PL.rhs_tile is LS.rhs_tile
    assert C.clamp_threads(10 ** 6) == LS.MAX_THREADS == PL.MAX_THREADS
    proc = _run(["-c", "import sys, repro_torch.launch_shapes; "
                       "assert 'torch' not in sys.modules"])
    assert proc.returncode == 0, proc.stderr


def _geom_plan(fmt, op, g, batch, params=None):
    p = {"schema_version": 1, "fmt": fmt, "rule": "fixed",
         "tier": "kernel", "batch": batch, "expected_iterations": 100,
         "transform": {"name": fmt, "params": dict(params or {})},
         "geometry": {op: g.to_dict()}, "machine": "", "d_mat": None,
         "d_star": None, "expected_gain": 0.0}
    if fmt == "sell":
        p["transform"]["params"] = {"slice_rows": 128, "width_quantum": 8}
    return p


@pytest.mark.parametrize("fmt", KT.GRID_FORMATS)
@pytest.mark.parametrize("op,batch", [("spmv", 1), ("spmm", 1),
                                      ("spmm", 3), ("spmm", 8),
                                      ("spmm", 32), ("spmm", 128)])
def test_every_candidate_geometry_lints_clean(fmt, op, batch):
    """The tuner's grid (the plans the port mints) carries no finding at
    all: no error, no clamp, no knob its kernel does not read."""
    shapes = [(1, 8, 5), (3, 1, 7), (37, 16, 300), (5000, 128, 80000)]
    n_cands = 0
    for n_rows, width, nnz_pad in shapes:
        widths = (4, 8, 16) if fmt == "bcsr" else (width,)
        for w in widths:
            params = {"block": w} if fmt == "bcsr" else None
            for g in KT.candidate_geometries(fmt, op, n_rows=n_rows,
                                             width=w, nnz_pad=nnz_pad,
                                             batch=batch):
                found = lint_plan(_geom_plan(fmt, op, g, batch, params))
                assert found == [], (g, [f.render() for f in found])
                n_cands += 1
    assert n_cands > 0


@pytest.mark.parametrize("batch", [1, 64, 65535, 65536, 200000, 10 ** 7])
@pytest.mark.parametrize("block_k", [1, 2, 8, 128, 500])
def test_every_grid_rejection_of_common_is_an_error(batch, block_k):
    """``check_grid_y`` is the launch helpers' one rejection a plan can
    carry: the lint errors exactly where ``row_group_launch`` raises."""
    try:
        C.row_group_launch(batch, block_k=block_k)
        rejected = False
    except ValueError:
        rejected = True
    g = KT.TileGeometry(block_rows=32, block_k=block_k)
    found = lint_plan(_geom_plan("ell_row", "spmm", g, batch))
    grid = [f for f in errors(found) if "grid.y" in f.message]
    assert bool(grid) == rejected
    # a clamped block_k is a warning, never an error
    assert any(f.severity == "warn" for f in found) == (block_k > 128)


@pytest.mark.parametrize("fmt,op,g,batch,params,lanes", [
    ("ell_row", "spmv", {"block_rows": 2048}, 1, {}, 1),
    ("csr", "spmm", {"block_rows": 64, "block_k": 32}, 32, {}, 32),
    ("bcsr", "spmv", {"block_rows": 256}, 1, {"block": 8}, 8),
    ("ccs", "spmm", {"block_rows": 128, "block_k": 16}, 16, {}, 16),
])
def test_clamped_block_rows_warn(fmt, op, g, batch, params, lanes):
    """``clamp_threads`` caps a block at 1024 threads: a tile past it is a
    warning (the launch still runs, with fewer rows a block)."""
    assert C.clamp_threads(g["block_rows"] * lanes) < \
        g["block_rows"] * lanes
    d = {"schema_version": 1, "fmt": fmt, "rule": "fixed", "tier": "kernel",
         "batch": batch, "expected_iterations": 1,
         "transform": {"name": fmt, "params": params},
         "geometry": {op: g}, "machine": "", "d_mat": None, "d_star": None,
         "expected_gain": 0.0}
    found = lint_plan(d)
    assert not has_errors(found)
    assert any("clamped" in f.message for f in found)


# ---------------------------------------------------------------------------
# AST lint (RPA)
# ---------------------------------------------------------------------------
BLIND = """\
def f(g):
    try:
        g()
    except Exception:
        pass
"""


def _both(code, path):
    port = lint_source(code, path)
    assert [(f.rule, f.line) for f in port] == \
        [(f.rule, f.line) for f in ref_lint_source(code, path)]
    return port


def test_rpa001_blind_except():
    assert "RPA001" in rules(_both(BLIND, "src/x.py"), "error")


@pytest.mark.parametrize("handler", [
    "        raise RuntimeError('wrapped') from e",
    "        tel.counter('errs').inc()",
    "        last_err = e",
])
def test_rpa001_accounted_handlers_pass(handler):
    code = (f"def f(g, tel):\n    try:\n        g()\n"
            f"    except Exception as e:\n{handler}\n")
    assert "RPA001" not in rules(_both(code, "src/x.py"))


def test_rpa001_noqa_same_line():
    code = BLIND.replace("except Exception:",
                         "except Exception:  # repro: noqa[RPA001]")
    assert _both(code, "src/x.py") == []


def test_rpa001_noqa_line_above():
    code = BLIND.replace(
        "    except Exception:",
        "    # best-effort cleanup — repro: noqa[RPA001]\n"
        "    except Exception:")
    assert _both(code, "src/x.py") == []


def test_bare_noqa_waives_everything():
    code = BLIND.replace("except Exception:",
                         "except Exception:  # repro: noqa")
    assert _both(code, "src/x.py") == []


def test_noqa_for_other_rule_does_not_waive():
    code = BLIND.replace("except Exception:",
                         "except Exception:  # repro: noqa[RPA005]")
    assert "RPA001" in rules(_both(code, "src/x.py"))


CLOCK = """\
import time
def flush_due(deadline):
    return time.time() > deadline
"""


def test_rpa002_clock_only_inside_serve():
    assert "RPA002" in rules(
        lint_source(CLOCK, "src/repro_torch/serve/queue.py"), "error")
    assert "RPA002" not in rules(
        lint_source(CLOCK, "src/repro_torch/core/queue.py"))


@pytest.mark.parametrize("code,path,flagged", [
    ("import torch\n", "src/repro_torch/obs/new_sink.py", True),
    ("import jax\n", "src/repro_torch/obs/new_sink.py", True),
    ("from torch import nn\n", "src/repro_torch/analyze/helper.py", True),
    ("import triton.language as tl\n", "src/repro_torch/analyze/h.py", True),
    ("import torch\n", "src/repro_torch/core/x.py", False),
    ("import jax.numpy as jnp\n", "src/repro_torch/core/x.py", True),
    ("from repro.core import plan\n", "src/repro_torch/core/x.py", True),
    ("import repro.obs\n", "src/repro_torch/serve/x.py", True),
    ("from ..core import plan\n", "src/repro_torch/serve/x.py", False),
    ("import repro_torch.obs\n", "src/repro_torch/serve/x.py", False),
    ("import jax\n", "src/repro/core/x.py", False),
])
def test_rpa003_framework_imports(code, path, flagged):
    """The port's own rule made a check: torch (and JAX, Triton) stay out
    of ``repro_torch/obs`` and ``repro_torch/analyze``; JAX and the JAX
    package stay out of all of ``repro_torch/``."""
    assert ("RPA003" in rules(lint_source(code, path), "error")) == flagged


TIMING = """\
import time
import torch
def bench(a):
    t0 = time.perf_counter()
    y = torch.mm(a, a){sync}
    t1 = time.perf_counter()
    return t1 - t0, y
"""


@pytest.mark.parametrize("sync,flagged", [
    ("", True),
    ("\n    torch.cuda.synchronize()", False),
    ("\n    end.synchronize()", False),
    ("\n    y.sum().item()", False),
])
def test_rpa004_timing_without_sync(sync, flagged):
    found = lint_source(TIMING.format(sync=sync), "src/bench.py")
    assert ("RPA004" in rules(found, "error")) == flagged


def test_rpa005_mutable_default():
    code = "def f(x, acc=[]):\n    acc.append(x)\n    return acc\n"
    assert "RPA005" in rules(_both(code, "src/x.py"), "error")
    assert "RPA005" not in rules(
        lint_source("def f(x, acc=None):\n    return acc\n", "src/x.py"))


def test_rpa000_unparseable_source():
    assert "RPA000" in rules(lint_source("def broken(:\n", "src/x.py"),
                             "error")


def test_port_source_passes_its_own_lint():
    from repro_torch.analyze import lint_paths
    found = lint_paths([os.path.join(SRC, "repro_torch")])
    assert not has_errors(found), "\n".join(f.render() for f in found)


# ---------------------------------------------------------------------------
# registry audit (RPR) — against the real tree
# ---------------------------------------------------------------------------
def test_audit_real_tree_has_no_errors():
    found = reg.audit(src=SRC, docs=DOCS)
    assert not has_errors(found), "\n".join(f.render() for f in found)


def test_emitted_telemetry_sees_known_names():
    emitted = reg.emitted_telemetry(Path(SRC) / "repro_torch")
    assert "store.quarantine" in emitted
    assert "service.plan_lint" in emitted
    assert "plan.lint" in emitted


def test_port_emits_only_the_documented_vocabulary():
    """Every dotted name the port emits is in the JAX package's
    vocabulary (``docs/observability.md``), which that package's own audit
    checks over all of ``src/``, the port included."""
    documented = reg.documented_telemetry(Path(DOCS))
    emitted = reg.emitted_telemetry(Path(SRC) / "repro_torch")
    assert set(emitted) <= documented, sorted(set(emitted) - documented)
    from repro.analyze import registry as ref_reg
    ref_found = ref_reg.audit(src=SRC, docs=DOCS)
    assert not any(f.severity == "error" for f in ref_found), \
        "\n".join(f.render() for f in ref_found)


def test_documented_telemetry_reads_the_vocabulary():
    documented = reg.documented_telemetry(Path(DOCS))
    assert documented is not None
    assert {"store.quarantine", "plan.lint", "tune.winner"} <= documented


def test_registrations_cover_reference_formats():
    provs = reg.providers(
        Path(SRC) / "repro_torch" / "core" / "dispatch.py")
    assert "reference" in provs and "kernel" in provs
    fmts, impls = set(), set()
    for tier in ("reference", "kernel"):
        for mod in provs[tier]:
            path = Path(SRC) / (os.path.join(*mod.split(".")) + ".py")
            f, i = reg.registrations(path)
            fmts |= f
            impls |= i
    assert "csr" in fmts and "sell" in fmts and "hybrid" in fmts
    assert ("csr", "spmv", "reference") in impls
    assert ("bcsr", "spmm", "kernel") in impls


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_lint_plan_good_fixture(capsys):
    assert analyze_main(["lint-plan", FIXTURE]) == 0
    assert "0 error(s)" in capsys.readouterr().out


def test_cli_lint_plan_bad_artifact(tmp_path, good, capsys):
    good["geometry"]["spmv"]["block_rows"] = 0
    bad = tmp_path / "bad_plan.json"
    bad.write_text(json.dumps(good))
    assert analyze_main(["lint-plan", str(bad)]) == 1
    assert "RPL002" in capsys.readouterr().out


def test_cli_smem_budget(tmp_path, good):
    p = tmp_path / "wide.json"
    p.write_text(json.dumps(_wide_csr(good)))
    assert analyze_main(["lint-plan", str(p)]) == 0
    assert analyze_main(["lint-plan", str(p), "--smem-budget", "64"]) == 1


def test_cli_lint_src_exit_codes(tmp_path, capsys):
    dirty = tmp_path / "dirty.py"
    dirty.write_text(BLIND)
    assert analyze_main(["lint-src", str(dirty)]) == 1
    capsys.readouterr()
    clean = tmp_path / "clean.py"
    clean.write_text("def f():\n    return 1\n")
    assert analyze_main(["lint-src", str(clean)]) == 0


def test_cli_strict_warn_promotes_warnings(tmp_path, good):
    good["fingerprint"]["mu"] = 99.0      # warning only
    p = tmp_path / "warny.json"
    p.write_text(json.dumps(good))
    assert analyze_main(["lint-plan", str(p)]) == 0
    assert analyze_main(["--strict-warn", "lint-plan", str(p)]) == 1


def test_cli_audit_real_tree():
    assert analyze_main(["audit", "--src", SRC, "--docs", DOCS]) == 0


def test_cli_usage_error():
    with pytest.raises(SystemExit) as exc:
        analyze_main(["no-such-command"])
    assert exc.value.code == 2


def _run(args):
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": SRC})


def test_cli_is_torch_free():
    proc = _run(["-c",
                 "import sys; import repro_torch.analyze, "
                 "repro_torch.analyze.cli; "
                 "from repro_torch.analyze.planlint import lint_plan; "
                 "bad = [m for m in ('torch', 'jax', 'repro') "
                 "if m in sys.modules]; "
                 "assert not bad, bad"])
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("args", [
    ["lint-plan", FIXTURE],
    ["lint-src", os.path.join(SRC, "repro_torch")],
    ["audit", "--src", SRC, "--docs", DOCS],
])
def test_module_subcommands_run_torch_free(args):
    """``python -m repro_torch.analyze`` exits 0 on the real tree and the
    fixture, and never imports torch (nor JAX)."""
    proc = _run(["-X", "importtime", "-m", "repro_torch.analyze", *args])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    imported = [ln.split("|")[-1].strip() for ln in proc.stderr.splitlines()]
    assert "torch" not in imported and "jax" not in imported


# ---------------------------------------------------------------------------
# integration: store quarantine, register(strict_lint=), planner self-check
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def problem():
    from repro.core.transform import csr_from_dense as r_csr
    from repro_torch.core.transform import csr_from_dense
    rng = np.random.default_rng(5)
    dense = (rng.random((64, 64)) < 0.1).astype(np.float32)
    return dense, r_csr(dense), csr_from_dense(dense, device="cpu")


def _corrupt(plan_dict):
    """Semantically break a plan in a way only the lint can see."""
    d = json.loads(json.dumps(plan_dict))
    if d.get("blocks"):
        d["blocks"][0]["rows"][0] = 8      # no longer tiles from row 0
    else:
        d["fingerprint"]["n"] = 0          # nnz on zero rows
    return d


def test_store_quarantines_lint_failures(tmp_path, problem):
    from repro_torch.core.plan import Planner
    from repro_torch.core.plan_store import (BAD_DIR, PlanStore, _canonical,
                                             _sha256)
    _, _, csr = problem
    store = PlanStore(str(tmp_path / "plans"))
    plan = Planner(device="cpu").plan(csr)
    key = store.key_for(csr, batch=1)
    path = store.put(key, plan)
    env = json.load(open(path))
    env["plan"] = _corrupt(env["plan"])
    env["sha256"] = _sha256(_canonical(env["plan"]))
    json.dump(env, open(path, "w"))
    assert store.get(key) is None          # quarantined, never raised
    assert store.quarantined == 1
    bad = os.listdir(tmp_path / "plans" / BAD_DIR)
    assert len(bad) == 1 and bad[0].endswith(".lint")


def test_register_strict_lint_raises(problem):
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.serve.spmv_service import SpMVService
    _, _, csr = problem
    svc = SpMVService(device="cpu")
    minted = svc.register("m", csr, measure_baseline=False).plan
    bad = ExecutionPlan.from_dict(_corrupt(minted.to_dict()))
    with pytest.raises(PlanLintError) as exc:
        svc.register("strict", csr, plan=bad, strict_lint=True,
                     measure_baseline=False)
    assert exc.value.findings                 # carries the findings
    assert "strict" not in svc.entries


def test_register_nonstrict_drops_plan_and_rebuilds(problem):
    import jax.numpy as jnp
    from repro.core.plan import ExecutionPlan as RPlan
    from repro.serve.spmv_service import SpMVService as RService
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.serve.spmv_service import SpMVService
    dense, rcsr, csr = problem
    minted = SpMVService(device="cpu").register(
        "m", csr, measure_baseline=False).plan
    bad = ExecutionPlan.from_dict(_corrupt(minted.to_dict()))
    svc = SpMVService(device="cpu")           # fresh: empty plan cache
    entry = svc.register("lax", csr, plan=bad, measure_baseline=False)
    assert entry.from_plan is False           # rebuilt, not replayed
    assert not has_errors(lint_plan(entry.plan.to_dict()))
    rsvc = RService()
    rentry = rsvc.register("lax", rcsr, plan=RPlan.from_dict(
        _corrupt(minted.to_dict())), measure_baseline=False)
    assert entry.plan.to_dict() == rentry.plan.to_dict()
    x = np.ones(64, np.float32)
    y = svc.spmv("lax", x).numpy()
    np.testing.assert_allclose(y, np.asarray(rsvc.spmv("lax", jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, dense @ x, rtol=1e-4, atol=1e-5)


def test_planner_self_check_rejects_corrupt_plan(problem):
    from repro_torch.core.plan import ExecutionPlan, PlanError, Planner
    _, _, csr = problem
    planner = Planner(device="cpu")
    assert planner.lint is True               # on by default
    plan = planner.plan(csr)                  # self-check passes on mint
    bad = ExecutionPlan.from_dict(_corrupt(plan.to_dict()))
    with pytest.raises(PlanError):
        planner._self_check(bad)
    assert Planner(lint=False)._self_check(bad) is bad


def test_planner_lint_smem_budget_reaches_the_lint(problem):
    """``lint_smem_budget`` is RPL004's budget at the mint: a kernel-tier
    plan whose K5 window cannot fit a 16 KiB part is refused there."""
    from repro_torch.core.kernel_tune import KernelTuner
    from repro_torch.core.plan import PlanError, Planner

    def timer(thunk, g):             # the widest column tile wins
        thunk()
        return 1.0 if g is None else 0.5 - (g.block_k or 0) * 1e-3

    _, _, csr = problem
    kw = dict(tuner=KernelTuner(timer=timer), device="cpu")
    plan = Planner(**kw).plan(csr, fmt="csr", batch=128)
    assert not has_errors(lint_plan(plan.to_dict()))
    with pytest.raises(PlanError, match="RPL004"):
        Planner(lint_smem_budget=16 * 1024, **kw).plan(csr, fmt="csr",
                                                       batch=128)


# ---------------------------------------------------------------------------
# container validators behind the lint
# ---------------------------------------------------------------------------
def test_new_validators_pass_on_real_transforms(problem):
    from repro_torch.core.formats import validate_container
    from repro_torch.core.transform import TRANSFORMS_HOST
    _, _, csr = problem
    for name, fn in TRANSFORMS_HOST.items():
        validate_container(fn(csr))


def test_validators_catch_corruption(problem):
    from repro_torch.core.formats import MatrixValidationError
    from repro_torch.core.transform import TRANSFORMS_HOST
    _, _, csr = problem
    coo = TRANSFORMS_HOST["coo_row"](csr)
    coo.cols[:csr.nnz] = csr.n_cols + 5       # out-of-range columns
    with pytest.raises(MatrixValidationError):
        coo.validate()
    ell = TRANSFORMS_HOST["ell_row"](csr)
    object.__setattr__(ell, "nnz", ell.data.numel() + 1)
    with pytest.raises(MatrixValidationError):
        ell.validate()
    bcsr = TRANSFORMS_HOST["bcsr"](csr)
    bcsr.indptr[0] = 1                        # indptr must start at 0
    with pytest.raises(MatrixValidationError):
        bcsr.validate()
    assert isinstance(bcsr.indptr, torch.Tensor)
