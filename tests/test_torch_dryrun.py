"""The port's dry run (``launch/{dryrun,roofline,perf}.py``) on the CPU:
fake CPU tensors at smoke size on fake worlds, held against the
reference's roofline formula, its HLO dot and FLOP counts, a hand count
of the collectives, ``MemTracker`` on real tensors, and its records,
variants and skips."""
import json
import math
import os
import subprocess
import sys

import jax
import pytest
torch = pytest.importorskip("torch")

from repro.configs import SHAPES as R_SHAPES, get_config as r_get
from repro.configs import smoke_config as r_smoke
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.launch import steps as RS
from repro.launch.mesh import make_mesh as r_make_mesh
from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import perf as P
from repro_torch.launch import roofline as R
from test_torch_launch_train import reference_dryrun
from test_torch_lm import ROOT
from test_torch_train_model import one_torch_thread  # noqa: F401

#: a smoke cell's per-device FLOPs against the reference's HLO count:
#: both count 2 M N K a product over the same einsums.  Decode: equal.
#: Train: the reference's is 2.4 % higher (read: 88 080 384 against
#: 85 983 232, a difference of 2^21): its HLO holds one more logits-sized
#: product (the backward of its cross-entropy chunk loop recomputes the
#: logits), which the port's step does not run
DECODE_FLOPS_RTOL = 1e-6
TRAIN_FLOPS_RTOL = 3e-2
#: a step of many microbatches extrapolated from its steps of 2 and 3
#: against its direct trace: FLOPs, collectives and peak exact; bytes
#: within 0.1 % (read 0.07 % on dbrx's smoke model at 8 microbatches)
LOOP_BYTES_RTOL = 1e-3


def reference_perf():
    """The reference's ``launch/perf.py``, imported as
    ``reference_dryrun`` imports its dry run (both set ``XLA_FLAGS`` for
    512 devices at import): after JAX is up, the flags put back."""
    reference_dryrun()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return perf


def smoke(arch, **kw):
    return smoke_config(get_config(arch)).replace(**kw)


def trace(cfg, shape, dims=(1, 1), **kw):
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]
    return D.trace_cell(cfg, shape, dims, axes, arch="a", mesh_name="m",
                        device="cpu", **kw)


def test_roofline_terms_and_bottleneck():
    """The reference's test (``tests/test_launch_roofline.py``) with the
    H100 constants: a second of compute, of memory, and 100 GB over the
    slowest link (50 GB/s between nodes) is two seconds of collectives."""
    r = R.Roofline(arch="a", shape="s", mesh="m", chips=256,
                   traced_flops=989e12, traced_bytes=3.35e12,
                   collective_bytes=100e9,
                   model_flops=989e12 * 256 * 0.5)
    r.finalize()
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(2.0)
    assert r.bottleneck == "collective"
    assert r.useful_ratio == pytest.approx(0.5)
    # by axis: each axis's bytes over the link its group spans
    r = R.Roofline(arch="a", shape="s", mesh="m", chips=16, traced_flops=1.0,
                   traced_bytes=1.0, collective_bytes=500e9, model_flops=1.0,
                   collectives_by_axis={"all_gather": {"model": 450e9},
                                        "all_reduce": {"data": 50e9}},
                   link_bw={"model": R.NVLINK_BW,
                            "data": R.INTER_NODE_BW}).finalize()
    assert r.t_collective == pytest.approx(2.0)


@pytest.mark.parametrize("dims,want", [
    ((16, 16), {0: R.INTER_NODE_BW, 1: R.INTER_NODE_BW}),
    ((2, 4), {0: R.NVLINK_BW, 1: R.NVLINK_BW}),
    ((4, 8), {0: R.INTER_NODE_BW, 1: R.NVLINK_BW}),
    ((2, 16, 16), {0: R.INTER_NODE_BW, 1: R.INTER_NODE_BW,
                   2: R.INTER_NODE_BW})])
def test_each_axis_is_charged_its_slowest_link(dims, want):
    """Ranks row-major over the mesh, eight cards a node: an axis whose
    group stays in one node rides NVLink, else the network."""
    assert {i: R.link_bw(D.axis_ranks(dims, i)) for i in range(len(dims))} \
        == want


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b"])
def test_decode_flops_are_the_references_unrolled_dot_count(arch):
    """A smoke decode cell on one rank: the traced FLOPs (K11 by its
    formula) against the reference's dot FLOPs of the unrolled compile
    (``weighted_costs(compiled.as_text()).dot_flops``)."""
    RD = reference_dryrun()
    from repro.launch.roofline import weighted_costs
    assert len(jax.devices()) == 1
    rcfg = RD.unrolled_cfg(r_smoke(r_get(arch)))
    mesh = r_make_mesh((1, 1), ("data", "model"))
    jfn, args = RS.jitted_step_for_cell(
        rcfg, RShapeConfig("d", 64, 4, "decode"), mesh, donate=False,
        microbatches=1)
    with mesh:
        want = weighted_costs(jfn.lower(*args).compile().as_text()).dot_flops
    rl, tr = trace(smoke(arch), ShapeConfig("d", 64, 4, "decode"))
    assert tr.ops[D.K11_OP] == sum(
        k in ("attn", "local") for k in D.unrolled_cfg(smoke(arch))
        .layer_pattern)
    assert rl.traced_flops == pytest.approx(want, rel=DECODE_FLOPS_RTOL)


#: the reference's smoke train cell on 8 placeholder devices (8x1), its
#: per-device HLO FLOPs printed as JSON
REFERENCE_8X1 = """
import json
from repro.launch import dryrun as RD
import jax
from repro.configs import get_config, smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.launch.roofline import from_compiled
from repro.launch.steps import jitted_step_for_cell
assert len(jax.devices()) == 8
cfg = smoke_config(get_config("qwen3-1.7b"))
shape = ShapeConfig("t", 64, 16, "train")
mesh = make_mesh((8, 1), ("data", "model"))
jfn, args = jitted_step_for_cell(cfg, shape, mesh, microbatches=1)
with mesh:
    compiled = jfn.lower(*args).compile()
rl = from_compiled(compiled, arch="a", shape="t", mesh_name="8x1", chips=8,
                   model_flops=RD.model_flops_for(cfg, shape))
print(json.dumps({"hlo_flops": rl.hlo_flops}))
"""


def test_data_parallel_train_cell_is_the_references_and_a_hand_count():
    """A smoke train cell on a fake 8x1 world, where the port splits work
    as the reference does (no model axis): its per-device FLOPs against
    the reference's ``hlo_flops`` on 8 placeholder devices; its collective
    bytes the FSDP gather of every sharded leaf plus one all-reduce of the
    flattened float32 gradients (and the two scalars of the loss)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import param_specs, params_sharding
    from repro_torch.sharding.rules import tree_leaves
    cfg = smoke("qwen3-1.7b")
    rl, tr = trace(cfg, ShapeConfig("t", 64, 16, "train"), (8, 1),
                   microbatches=1)
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE_8X1], cwd=ROOT, timeout=300,
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
             "REPRO_XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])["hlo_flops"]
    assert rl.traced_flops == pytest.approx(want, rel=TRAIN_FLOPS_RTOL)

    specs = tree_leaves(param_specs(cfg))
    with D.fake_world(8):
        placed = tree_leaves(params_sharding(
            cfg, make_mesh((8, 1), ("data", "model"), device="cpu")))
        sharded = [any(p.is_shard() for p in sh.placements)
                   for sh in placed]
    gathered = sum(math.prod(s.shape) * 4 for s, g in zip(specs, sharded)
                   if g)
    grads = sum(math.prod(s.shape) * 4 for s in specs)
    assert tr.collective_bytes == {("all_gather", "data"): gathered,
                                   ("all_reduce", "data"): grads + 4 + 4}
    assert tr.collective_calls == {("all_gather", "data"): sum(sharded),
                                   ("all_reduce", "data"): 3}
    assert rl.collectives_by_axis == {"all_gather": {"data": gathered},
                                      "all_reduce": {"data": grads + 8}}
    assert rl.link_bw == {"data": R.NVLINK_BW}


#: a step's FLOPs on a mesh against one device's share of them: the
#: products are split exactly; what stays replicated on each rank of a
#: ``model`` group (the norms and the softmax count no FLOP; dbrx's router
#: is split over its experts) is under this share of the step
SPLIT_FLOPS_RTOL = 1e-3


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "dbrx-132b"])
def test_the_model_axis_splits_compute(arch):
    """A smoke train cell (resolved for a model axis of 4) on 2x2 and 1x4
    meshes: each rank traces a quarter of one device's FLOPs (heads,
    ``d_ff``, experts and the vocabulary split over ``model``, the batch
    over ``data``); on 2x1 a half."""
    cfg = smoke(arch).resolve_for_tp(4)
    shape = ShapeConfig("t", 64, 16, "train")
    one, _ = trace(cfg, shape, microbatches=1)
    for dims, parts in (((2, 2), 4), ((1, 4), 4), ((2, 1), 2)):
        mesh, _ = trace(cfg, shape, dims, microbatches=1)
        assert mesh.traced_flops == pytest.approx(one.traced_flops / parts,
                                                  rel=SPLIT_FLOPS_RTOL), dims


def test_memtracker_peak_on_fake_tensors_is_its_peak_on_real_ones(
        one_torch_thread):
    """The same smoke train step (one device, float32 masters) under
    ``MemTracker`` on fake CPU tensors and on real ones: the same peak,
    argument and output bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = smoke("qwen3-1.7b", n_layers=2)
    shape = ShapeConfig("t", 32, 4, "train")
    fn, specs, _ = D.cell_step(cfg, shape, None, microbatches=1)

    _, real = R.trace_step(fn, _fill(specs, torch.Generator().manual_seed(0)))
    with FakeTensorMode():
        _, fake = R.trace_step(fn, D.fake_tree(specs, "cpu"))
    assert real.peak_bytes > real.argument_bytes > 0
    assert (fake.peak_bytes, fake.argument_bytes, fake.output_bytes,
            fake.alias_bytes, fake.flops, fake.bytes) == \
        (real.peak_bytes, real.argument_bytes, real.output_bytes,
         real.alias_bytes, real.flops, real.bytes)


def _fill(specs, g):
    """Real CPU tensors of a spec tree: small normal floats, token ids."""
    from repro_torch.launch.steps import TensorSpec
    if isinstance(specs, TensorSpec):
        if specs.dtype.is_floating_point:
            return (torch.randn(specs.shape, generator=g) * 0.02).to(
                specs.dtype)
        return torch.randint(0, 64, specs.shape, generator=g,
                             dtype=specs.dtype)
    if isinstance(specs, dict):
        return {k: _fill(v, g) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_fill(v, g) for v in specs]
    vals = [_fill(v, g) for v in specs]
    return type(specs)(*vals) if hasattr(specs, "_fields") else tuple(vals)


def test_decode_trace_holds_k11_and_no_dequantized_cache():
    """A decode cell's trace calls K11's custom operator once an attention
    layer and no aten op reads the int8 cache (the plain version's
    dequantized copy), on one rank and on a mesh."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Int8Reads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.aten = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "aten" and any(
                    isinstance(a, torch.Tensor) and a.dtype == torch.int8
                    and a.dim() == 4 for a in args):
                self.aten.append(str(func))
            return func(*args, **(kwargs or {}))

    cfg = smoke("qwen3-1.7b")
    shape = ShapeConfig("d", 64, 8, "decode")
    for dims in ((1, 1), (4, 2)):
        seen = Int8Reads()
        with seen:
            rl, tr = trace(cfg, shape, dims)
        assert tr.ops[D.K11_OP] == cfg.n_layers
        assert seen.aten and not [
            op for op in seen.aten
            if op.startswith(("aten._to_copy", "aten.mul"))], seen.aten


def test_run_cell_records_the_references_keys(tmp_path, monkeypatch):
    """``run_cell``'s record: the reference's layout with the renames of
    the module docstring; ``long_500k`` skips a full-attention arch with
    the reference's reason; ``analyze_cell`` adds the reference's
    ``analytic`` keys and the unrolled trace.  Smoke configs on small
    meshes under the production names."""
    monkeypatch.setattr(D, "get_config",
                        lambda a: smoke_config(get_config(a)))
    monkeypatch.setitem(D.MESHES, False, ("16x16", (4, 2), ("data", "model")))
    monkeypatch.setattr(D, "SHAPES", {
        "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
        "long_500k": SHAPES["long_500k"]})
    rec = D.run_cell("qwen3-1.7b", "decode_32k", False, str(tmp_path),
                     device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    with open(tmp_path / "qwen3-1.7b__decode_32k__16x16.json") as f:
        assert json.load(f) == rec
    assert set(rec) == {"arch", "shape", "mesh", "status", "device",
                        "roofline", "memory", "timings", "collective_calls",
                        "comm_counts", "k11_calls", "serve_weight_stationary"}
    # the reference's default: a decode cell runs weight-stationary
    assert rec["serve_weight_stationary"] is True
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes", "peak_bytes",
                                  "fits_80gb"}
    rl = rec["roofline"]
    for key in ("arch", "shape", "mesh", "chips", "collective_bytes",
                "model_flops", "t_compute", "t_memory", "t_collective",
                "bottleneck", "useful_ratio", "bytes_per_device",
                "peak_memory_gb", "collectives"):
        assert key in rl
    assert "traced_flops" in rl and "hlo_flops" not in rl
    assert rl["chips"] == 8 and rl["mesh"] == "16x16"
    assert rec["timings"].keys() == {"trace_s"}

    skip = D.run_cell("qwen3-1.7b", "long_500k", False, str(tmp_path))
    RD = reference_dryrun()
    want = RD.skip_reason(r_get("qwen3-1.7b"), R_SHAPES["long_500k"])
    assert skip == {"arch": "qwen3-1.7b", "shape": "long_500k",
                    "mesh": "16x16", "status": "skip", "reason": want}

    D.analyze_cell("qwen3-1.7b", "decode_32k", False, str(tmp_path),
                   unroll=True, device="cpu")
    with open(tmp_path / "qwen3-1.7b__decode_32k__16x16.json") as f:
        rec = json.load(f)
    assert set(rec["analytic"]) == {
        "flops_dev", "bytes_dev", "collective_bytes_dev", "t_compute",
        "t_memory", "t_collective", "bottleneck", "model_flops_global",
        "useful_ratio", "detail"}
    assert rec["traced_unrolled"]["traced_flops"] == rl["traced_flops"]


def test_a_failed_cell_is_recorded_and_the_run_exits_1(tmp_path,
                                                         monkeypatch):
    """An error in a cell lands in its record (status, error, traceback)
    and ``main`` exits 1 after the rest; no fake world is left up."""
    import torch.distributed as dist

    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(D, "trace_cell", boom)
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--mesh",
                "single", "--out", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 1
    with open(tmp_path / "qwen3-1.7b__decode_32k__16x16.json") as f:
        rec = json.load(f)
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: boom"
    assert "traceback" in rec and not dist.is_initialized()


def test_a_cell_past_its_time_limit_is_an_error(tmp_path):
    """With a time limit a cell runs in a child process, killed past the
    limit (a trace cannot be interrupted inside the dispatcher): its
    record says so; within the limit the child's record is the cell's."""
    rec = D.run_cell("qwen3-1.7b", "decode_32k", False, str(tmp_path),
                     device="cpu", time_limit_s=0.5)
    assert rec["status"] == "error"
    assert rec["error"] == "TimeoutError: the trace ran past its 0.5 s limit"
    with open(tmp_path / "qwen3-1.7b__decode_32k__16x16.json") as f:
        assert json.load(f) == rec


def test_the_fake_world_is_destroyed_and_refuses_a_live_one():
    import torch.distributed as dist
    with D.fake_world(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="world is up"):
            with D.fake_world(2):
                pass
    assert not dist.is_initialized()


def test_a_microbatch_of_fewer_rows_than_batch_shards_is_padded():
    """16 rows in 8 microbatches are 2 rows a microbatch, fewer than the
    4 batch shards: each microbatch is padded to 4 rows (the padding's
    labels all ``-1``), so rank 0 traces one row a microbatch, as in a
    cell of 32 rows; and the fake world is gone after."""
    import torch.distributed as dist
    cfg = smoke("qwen3-1.7b")
    padded, _ = trace(cfg, ShapeConfig("t", 64, 16, "train"), (4, 1),
                      microbatches=8)
    even, _ = trace(cfg, ShapeConfig("t", 64, 32, "train"), (4, 1),
                    microbatches=8)
    assert padded.traced_flops == even.traced_flops
    assert not dist.is_initialized()


def test_the_chokepoint_cross_check_catches_a_bypass():
    """A process-group op that did not go through
    ``sharding/collectives.py`` fails the trace's cross-check."""
    tr = R.StepTrace(flops=0, bytes=0,
                     collective_bytes={("all_gather", "g"): 8},
                     collective_calls={("all_gather", "g"): 1},
                     comm_counts={"c10d.allgather_": 1,
                                  "c10d.allreduce_": 1},
                     peak_bytes=0, argument_bytes=0, output_bytes=0,
                     alias_bytes=0, ops={}, seconds=0)
    with pytest.raises(AssertionError, match="outside"):
        D.check_chokepoint(tr)
    D.check_chokepoint(R.StepTrace(**{**tr.__dict__, "comm_counts": {
        "c10d.allgather_": 1}}))


def test_a_long_microbatch_loop_is_its_direct_trace():
    """A train step of 8 microbatches traced at 2 and 3 and extrapolated
    against its direct trace (dbrx's smoke model: MoE, 4x2 mesh)."""
    cfg = smoke("dbrx-132b")
    shape = ShapeConfig("t", 32, 32, "train")
    got, gtr = trace(cfg, shape, (4, 2), microbatches=8)
    assert gtr.microbatches_traced == (2, 3)
    old = D.LOOP_TRACED
    D.LOOP_TRACED = 100
    try:
        want, wtr = trace(cfg, shape, (4, 2), microbatches=8)
    finally:
        D.LOOP_TRACED = old
    assert wtr.microbatches_traced == ()
    assert got.traced_flops == want.traced_flops
    assert gtr.ops == wtr.ops
    assert gtr.collective_bytes == wtr.collective_bytes
    assert gtr.collective_calls == wtr.collective_calls
    assert (gtr.peak_bytes, gtr.argument_bytes, gtr.output_bytes) == \
        (wtr.peak_bytes, wtr.argument_bytes, wtr.output_bytes)
    assert got.traced_bytes == pytest.approx(want.traced_bytes,
                                             rel=LOOP_BYTES_RTOL)


def _data_gathers(tr):
    return tr.collective_bytes.get(("all_gather", "data"), 0)


def test_serve_weight_stationary_raises_naming_the_mechanism():
    """(Once a refusal; now the mechanism itself.)  A decode cell runs
    weight-stationary by default, as the reference's does: on 2x2 its
    trace is the one with ``serve_weight_stationary=True``, and the only
    bytes it gathers over ``data`` are the attention outputs of the
    rank's batch rows (B x the rank's heads x head_dim, float32, a layer)
    — no parameter — where ``serve_weight_stationary=False`` gathers every
    FSDP-sharded parameter; on one device the three are one step."""
    cfg = smoke("qwen3-1.7b")
    shape = ShapeConfig("d", 64, 4, "decode")
    for dims in ((1, 1), (2, 2)):
        (dflt, dtr), (ws, wtr), (gat, gtr) = (
            trace(cfg, shape, dims, **kw) for kw in (
                {}, {"serve_weight_stationary": True},
                {"serve_weight_stationary": False}))
        assert dflt.traced_flops == ws.traced_flops
        assert dtr.collective_bytes == wtr.collective_bytes
        if dims == (1, 1):
            assert dflt.traced_flops == gat.traced_flops
            assert not dtr.collective_bytes and not gtr.collective_bytes
            continue
        rows = cfg.n_layers * 4 * (cfg.n_heads // 2) * cfg.head_dim * 4
        assert _data_gathers(dtr) == rows
        assert _data_gathers(gtr) > 10 * rows
        assert dtr.ops[D.K11_OP] == cfg.n_layers


def test_a_b1_decode_cell_reads_the_closed_forms_flops():
    """B = 1 on a fake 4x2 world: the cache's sequence split over ``data``
    (context parallelism, K11 on the rank's slots, the softmaxes merged by
    their log-sum-exps), every product on the rank's ``d`` x ``model``
    shard of its weights: rank 0 traces at most 1.3x the closed form's
    FLOPs a device (the ranks no longer repeat the step), gathers nothing
    over ``data``, and merges each attention layer's softmax there."""
    from repro_torch.launch.analytic import analytic_costs
    for arch in ("qwen3-1.7b", "gemma3-12b"):
        cfg = smoke(arch).resolve_for_tp(2)
        shape = ShapeConfig("d", 64, 1, "decode")
        rl, tr = trace(cfg, shape, (4, 2))
        ac = analytic_costs(cfg.replace(kv_quant=True), shape, 8, 4, 2)
        assert rl.traced_flops <= 1.3 * ac.flops, arch
        assert _data_gathers(tr) == 0, arch
        assert tr.ops[D.K11_OP] == cfg.n_layers, arch


@pytest.mark.parametrize("arch,layers", [("zamba2-1.2b", 6),
                                         ("xlstm-1.3b", 8),
                                         ("musicgen-medium", 2)])
def test_weight_stationary_decode_data_bytes_are_under_the_closed_form(
        arch, layers):
    """The three small models whose weight-stationary decode moves only
    7.1-8.4x fewer ``data`` bytes than a gathered step at 16x16: their
    float32 partial sums are the design (``collectives.data_sum``), and the
    bf16 closed form (``analytic_costs``: ``2 layers B d 2`` bytes over
    ``data`` a step) bounds them all the same.  At full width, cut to one
    period of the layer pattern, B = 128, on a fake 2x16 world (the cell's
    ``model`` axis; the bytes a rank moves over ``data`` do not depend on
    its size): rank 0's traced ``data`` bytes are at or under the closed
    form's collective bytes, and its ``data`` all-gathers (batch rows, no
    parameter) under a tenth of the parameters a rank holds on ``model``.
    On a ``model`` axis of 2 the same step reads above the closed form: a
    rank's partial sums there are half of each product, not a sixteenth."""
    from repro_torch.launch.analytic import analytic_costs
    from repro_torch.models.model import n_params
    cfg = get_config(arch).replace(n_layers=layers).resolve_for_tp(16)
    shape = ShapeConfig("d", 128, 128, "decode")
    _, tr = trace(cfg, shape, (2, 16), memory=False)
    ac = analytic_costs(cfg.replace(kv_quant=True), shape, 32, 2, 16)
    data = sum(v for (op, axis), v in tr.collective_bytes.items()
               if axis == "data")
    assert 0 < data <= ac.collective_bytes
    assert 10 * _data_gathers(tr) <= n_params(cfg) * 2 / 16
    assert tr.ops.get(D.K11_OP, 0) == sum(
        k in ("attn", "mamba_attn") for k in D.unrolled_cfg(cfg).layer_pattern)


def test_perf_variants_are_the_references():
    """The same names, the same config transforms (the fields each
    changes) and the same step keywords."""
    RP = reference_perf()
    assert len(jax.devices()) == 1
    assert P.VARIANTS.keys() == RP.VARIANTS.keys()
    for arch in ("dbrx-132b", "gemma3-12b", "xlstm-1.3b"):
        cfg, rcfg = get_config(arch), r_get(arch)
        for name, (fn, kw) in P.VARIANTS.items():
            rfn, rkw = RP.VARIANTS[name]
            assert kw == rkw, name
            changed = {f: getattr(fn(cfg), f) for f in cfg.__dataclass_fields__
                       if getattr(fn(cfg), f) != getattr(cfg, f)}
            rchanged = {f: getattr(rfn(rcfg), f)
                        for f in rcfg.__dataclass_fields__
                        if getattr(rfn(rcfg), f) != getattr(rcfg, f)}
            assert changed == rchanged, name


def test_perf_runs_a_variant_and_refuses_weight_stationary(tmp_path,
                                                            monkeypatch):
    """(Once a refusal.)  A variant runs, and the ``serve_ws`` variants
    run too: ``serve_ws`` is the default decode cell's trace,
    ``serve_ws_bf16`` its bf16-cache one."""
    monkeypatch.setattr(P, "get_config",
                        lambda a: smoke_config(get_config(a)))
    monkeypatch.setitem(D.MESHES, False, ("16x16", (2, 2), ("data", "model")))
    monkeypatch.setattr(P, "SHAPES", {
        "decode_32k": ShapeConfig("decode_32k", 64, 4, "decode")})
    rec = P.run_variant("qwen3-1.7b", "decode_32k", "kv_bf16",
                        str(tmp_path), device="cpu")
    assert rec["unrolled"]["traced_flops"] == rec["traced"]["traced_flops"]
    assert set(rec["analytic"]) == {"t_compute_ms", "t_memory_ms",
                                    "t_collective_ms"}
    base = P.run_variant("qwen3-1.7b", "decode_32k", "base", str(tmp_path),
                         device="cpu")
    ws = P.run_variant("qwen3-1.7b", "decode_32k", "serve_ws", str(tmp_path),
                       device="cpu")
    assert ws["traced"] == base["traced"]
    bf16 = P.run_variant("qwen3-1.7b", "decode_32k", "serve_ws_bf16",
                         str(tmp_path), device="cpu")
    assert bf16["traced"]["collective_bytes"] == \
        rec["traced"]["collective_bytes"]


def test_the_dry_run_cli_writes_an_ok_record(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "long_500k", "--mesh", "both", "--out",
         str(tmp_path), "--device", "cpu"], cwd=ROOT, timeout=300,
        capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: 0 ok, 2 skip(design), 0 error" in out.stdout
    assert sorted(os.listdir(tmp_path)) == [
        "qwen3-1.7b__long_500k__16x16.json",
        "qwen3-1.7b__long_500k__2x16x16.json"]
