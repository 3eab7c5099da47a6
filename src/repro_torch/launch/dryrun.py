"""The dry run: each (architecture x shape x mesh) cell's step traced for
rank 0 of a fake world of H100s, with its roofline terms and peak memory.

The port of the JAX package's ``launch/dryrun.py``.  The reference lowers
and compiles every cell for 256 or 512 placeholder TPU devices and reads
XLA's memory and cost analysis.  The port traces rank 0's step instead,
one H100 a rank:

  * the world: a fake process group of 256 (``16x16``) or 512
    (``2x16x16``) ranks (PyTorch's private
    ``torch.testing._internal.distributed.fake_pg``), this process its rank
    0, and a ``DeviceMesh`` over it; the group is destroyed after each
    cell, so none is left behind for a process that later starts a real
    world;
  * the arguments: fake tensors made from ``jitted_step_for_cell``'s
    ``TensorSpec``s and placed as its shardings place them (each rank's
    shard), on the device type the cell targets (``cuda`` by default,
    ``--device cpu`` where there is no card); nothing is allocated;
  * the readings: ``launch/roofline.py`` (FLOPs, bytes, collective bytes
    by op and mesh axis, peak memory; what stands in for each XLA reading
    and what it cannot see).

A cell on one device (a ``1x1`` mesh: ``launch/train.py --dry-run``) runs
the step the trainer runs on one device, with no world.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun  # every cell, cuda

The record is the reference's JSON layout and file name
(``<arch>__<shape>__<mesh>.json``), under ``experiments/dryrun_torch/``
by default; keys renamed or dropped:

  * ``roofline.hlo_flops`` -> ``traced_flops``, ``hlo_bytes`` ->
    ``traced_bytes``; ``hlo_flops_body``, ``collective_bytes_body`` and
    ``loop_trips`` are dropped (the trace runs every loop iteration);
    ``collectives`` is keyed by the chokepoint's ops (``all_gather``,
    ``all_reduce``, ``reduce_scatter``, ``broadcast``, ``ring_shift``)
    where the reference's is keyed by HLO op; ``collectives_by_axis`` and ``link_bw`` are new;
  * ``memory.fits_16gb`` (the reference's TPU chip) -> ``fits_80gb`` (an H100);
    ``generated_code_bytes`` is dropped (no compiled program);
  * ``timings.lower_s`` and ``compile_s`` -> ``timings.trace_s``;
  * ``hlo_unrolled`` (``--analysis``, decode cells) -> ``traced_unrolled``;
  * new: ``device``, ``collective_calls`` (the chokepoint's, by op and
    axis), ``comm_counts`` (``CommDebugMode``'s), ``k11_calls``,
    ``microbatches_traced`` (a long microbatch loop traced at 2 and 3 and
    extrapolated: ``trace_cell``), and on a serving cell
    ``serve_weight_stationary`` (as the step ran it: the reference's
    default, true for a decode cell and false for a prefill).

A collective inside a region that ``remat`` recomputes runs again in the
backward; the trace counts it where it runs, so a recomputed one is
counted twice (the reference's HLO holds the recomputation too).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
from dataclasses import replace
from typing import Any, Optional, Sequence, Tuple

import torch

from ..configs import ARCH_IDS, SHAPES, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import n_active_params
from .roofline import (HBM_BW, HBM_PER_CARD, PEAK_FLOPS_BF16, Roofline,
                       StepTrace, private_module, from_trace, link_bw, on_axes,
                       trace_step)

#: the reference's production meshes: multi_pod -> (name, dims, axes)
MESHES = {False: ("16x16", (16, 16), ("data", "model")),
          True: ("2x16x16", (2, 16, 16), ("pod", "data", "model"))}
#: K11's custom operator, as a trace names it
K11_OP = "repro_torch.decode_attention_int8.default"
#: a chokepoint collective and the process-group op ``CommDebugMode``
#: counts for it on the fake world (it does not count the point-to-point
#: ops of ``ring_shift``; a ``gloo`` world runs a reduce-scatter as an
#: all-reduce: ``collectives.reduce_scatter``)
_COMM_OP_OF = {"all_gather": "c10d.allgather_",
               "all_reduce": "c10d.allreduce_",
               "reduce_scatter": "c10d._reduce_scatter_base_",
               "broadcast": "c10d.broadcast_"}


def unrolled_cfg(cfg: ModelConfig) -> ModelConfig:
    """The layer pattern expanded to full depth (one repetition of a
    ``period == n_layers`` pattern)."""
    full = (tuple(cfg.layer_pattern) * cfg.scan_reps +
            tuple(cfg.remainder_pattern))
    return cfg.replace(layer_pattern=full, n_layers=len(full))


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("SKIP(design): pure full-attention arch defines no "
                "sub-quadratic mechanism for 524k context (DESIGN.md §5)")
    return ""


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Model FLOPs of one step: 6 N D for training (2 N D forward, 4 N D
    backward), 2 N D otherwise, N the active parameters, D the tokens."""
    n_act = n_active_params(cfg)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_act * tokens


# ---------------------------------------------------------------------------
# the fake world and the step's arguments
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a fake world of ``size`` ranks (no
    communication happens; collectives return at once), destroyed on
    exit."""
    import torch.distributed as dist
    fake_pg = private_module("torch.testing._internal.distributed.fake_pg")
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is up in this "
                           "process: the dry run's fake world would "
                           "replace it")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_tree(specs: Any, device: str) -> Any:
    """Tensors of a tree of ``TensorSpec`` leaves (dicts, lists, tuples,
    optimizer states) under the active ``FakeTensorMode``."""
    from .steps import TensorSpec
    if isinstance(specs, TensorSpec):
        return torch.empty(specs.shape, dtype=specs.dtype, device=device)
    if isinstance(specs, dict):
        return {k: fake_tree(v, device) for k, v in specs.items()}
    if isinstance(specs, list):
        return [fake_tree(v, device) for v in specs]
    if isinstance(specs, tuple):
        vals = [fake_tree(v, device) for v in specs]
        return type(specs)(*vals) if hasattr(specs, "_fields") else \
            tuple(vals)
    return specs


def cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
              donate: bool = True, microbatches: Optional[int] = None,
              mixed_precision: bool = False, **kw):
    """``(step, arg specs, arg shardings)`` of a cell: ``jitted_step_for_cell``
    on a mesh (keywords passed on); with ``mesh=None`` the step one device
    runs (``make_train_step(inplace=donate)`` as the trainer builds it,
    the prefill and serve steps) and no shardings."""
    from ..optim import adamw
    from . import steps as S
    if mesh is not None:
        fn, specs = S.jitted_step_for_cell(
            cfg, shape, mesh, donate=donate, microbatches=microbatches,
            mixed_precision=mixed_precision, **kw)
        return fn, specs, fn.shardings
    if shape.kind == "train":
        mb = (microbatches if microbatches is not None
              else S.default_microbatches(cfg, shape))
        fn = S.make_train_step(cfg, adamw.AdamWConfig(), microbatches=mb,
                               mixed_precision=mixed_precision,
                               inplace=donate)
        p32 = S.param_specs(cfg, torch.float32)
        step = S.TensorSpec((), torch.int32)
        opt = (adamw.AdamWMixedState(step=step, m=p32, v=p32, master=p32)
               if mixed_precision else
               adamw.AdamWState(step=step, m=p32, v=p32))
        params = S.param_specs(cfg, torch.bfloat16) if mixed_precision \
            else p32
        return fn, (params, opt, S.input_specs(cfg, shape)), None
    # one device: weight-stationary or not, the same step
    kv = kw.get("kv_quant")
    cfg = cfg.replace(kv_quant=True if kv is None else kv)
    params = S.param_specs(cfg, torch.bfloat16)
    caches = S.cache_specs(cfg, shape)
    inputs = S.input_specs(cfg, shape)
    if shape.kind == "prefill":
        return S.make_prefill_step(cfg), (params, inputs, caches), None
    return (S.make_serve_step(cfg),
            (params, inputs["tokens"], caches, S.TensorSpec((), torch.int32)),
            None)


def _place(args: tuple, shardings: Optional[tuple]) -> tuple:
    from .steps import distribute
    if shardings is None:
        return args
    return tuple(a if sh is None else distribute(a, sh)
                 for a, sh in zip(args, shardings, strict=True))


#: a train step of more microbatches than this is traced at 2 and 3 and
#: extrapolated (``trace_cell``)
LOOP_TRACED = 5


def trace_cell(cfg: ModelConfig, shape: ShapeConfig,
               dims: Sequence[int], axes: Sequence[str], *, arch: str,
               mesh_name: str, device: str = "cuda", memory: bool = True,
               microbatches: Optional[int] = None,
               **step_kw) -> Tuple[Roofline, StepTrace]:
    """Trace rank 0's step of a cell on a fake world of ``prod(dims)``
    ranks (none for one) and read its roofline; ``step_kw`` go to
    :func:`cell_step`.

    A train step of ``M > LOOP_TRACED`` microbatches runs the same ops for
    every microbatch after the first (its slice of rows, forward and
    backward, the gradients added in float32): its steps of 2 and 3
    microbatches of the same rows are traced and the difference, one
    microbatch, counted ``M - 2`` times past the 2 (the reference weighs
    its scan body by the loop's trip count the same way); the peak is the
    3-microbatch step's, every later microbatch repeating its pattern."""
    from .steps import default_microbatches
    m = microbatches
    if shape.kind == "train" and m is None:
        m = default_microbatches(cfg, shape)
    if shape.kind == "train" and m > LOOP_TRACED:
        rows = shape.global_batch // m
        (t2, rates), (t3, _) = (_trace_once(
            cfg, replace(shape, global_batch=k * rows), dims, axes, device,
            memory, microbatches=k, **step_kw) for k in (2, 3))
        tr = _loop(t2, t3, m - 2)
        # the whole batch is an argument on every rank
        extra = _batch_bytes(cfg, shape) - _batch_bytes(
            cfg, replace(shape, global_batch=3 * rows))
        tr.argument_bytes += extra
        tr.peak_bytes += extra
    else:
        tr, rates = _trace_once(cfg, shape, dims, axes, device, memory,
                                microbatches=m, **step_kw)
    return from_trace(tr, arch=arch, shape=shape.name, mesh_name=mesh_name,
                      chips=math.prod(dims),
                      model_flops=model_flops_for(cfg, shape),
                      link_rates=rates), tr


def _trace_once(cfg, shape, dims, axes, device, memory, **step_kw):
    """``(trace keyed by mesh axis, link rate a mesh axis)`` of one step
    (:func:`trace_cell`'s one trace)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .mesh import make_mesh
    with contextlib.ExitStack() as stack:
        mesh = None
        if math.prod(dims) > 1:
            stack.enter_context(fake_world(math.prod(dims)))
            mesh = make_mesh(dims, axes, device=device)
        fn, specs, shardings = cell_step(cfg, shape, mesh, **step_kw)
        with FakeTensorMode():
            args = _place(fake_tree(specs, device), shardings)
            _, tr = trace_step(fn, args, memory=memory)
        check_chokepoint(tr)
        return on_axes(tr, mesh)


def _loop(t2: StepTrace, t3: StepTrace, trips: int) -> StepTrace:
    """The trace of a step whose loop body ran ``trips`` times past the
    two of ``t2``: ``t2 + trips * (t3 - t2)`` of every count."""
    def lin(a, b):
        return a + trips * (b - a)

    def table(a, b):
        return {k: lin(a.get(k, 0), b.get(k, 0)) for k in {*a, *b}}
    return StepTrace(
        flops=lin(t2.flops, t3.flops), bytes=lin(t2.bytes, t3.bytes),
        collective_bytes=table(t2.collective_bytes, t3.collective_bytes),
        collective_calls=table(t2.collective_calls, t3.collective_calls),
        comm_counts=table(t2.comm_counts, t3.comm_counts),
        peak_bytes=max(t2.peak_bytes, t3.peak_bytes),
        argument_bytes=t3.argument_bytes, output_bytes=t3.output_bytes,
        alias_bytes=t3.alias_bytes, ops=table(t2.ops, t3.ops),
        seconds=t2.seconds + t3.seconds, microbatches_traced=(2, 3))


def _batch_bytes(cfg: ModelConfig, shape: ShapeConfig) -> int:
    from .steps import input_specs
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in input_specs(cfg, shape).values())


def check_chokepoint(tr: StepTrace) -> None:
    """Every process-group op ``CommDebugMode`` saw went through the
    chokepoint of ``sharding/collectives.py`` (the same count a kind)."""
    calls = {}
    for (op, _), n in tr.collective_calls.items():
        calls[op] = calls.get(op, 0) + n
    want = {_COMM_OP_OF[op]: n for op, n in calls.items()
            if op in _COMM_OP_OF}
    got = {k: v for k, v in tr.comm_counts.items() if v}
    if got != want:
        raise AssertionError(f"collectives outside sharding/collectives.py: "
                             f"CommDebugMode counted {got}, the chokepoint "
                             f"{want}")


def axis_ranks(dims: Sequence[int], i: int) -> list:
    """Global ranks of rank 0's group along mesh dim ``i`` (ranks laid out
    row-major over ``dims``, as ``DeviceMesh`` lays out a world)."""
    stride = math.prod(dims[i + 1:])
    return [k * stride for k in range(dims[i])]


def slowest_link(dims: Sequence[int]) -> float:
    """The rate of the slowest link any axis of a mesh of ``dims`` spans
    (what the closed form's collective bytes are charged at)."""
    return min(link_bw(axis_ranks(dims, i)) for i in range(len(dims)))


def memory_of(tr: StepTrace) -> dict:
    """The reference's ``memory`` record from a trace's readings."""
    temp = max(tr.peak_bytes - tr.argument_bytes - tr.output_bytes +
               tr.alias_bytes, 0)
    return {"argument_bytes": tr.argument_bytes,
            "output_bytes": tr.output_bytes, "temp_bytes": temp,
            "alias_bytes": tr.alias_bytes, "peak_bytes": tr.peak_bytes,
            "fits_80gb": bool(tr.peak_bytes < HBM_PER_CARD)}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
def _keyed(d: dict) -> dict:
    """``(op, axis) -> n`` as ``{"op/axis": n}`` for JSON."""
    return {f"{op}/{axis}": n for (op, axis), n in sorted(d.items())}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             donate: bool = True, device: str = "cuda",
             time_limit_s: Optional[float] = None) -> dict:
    """Trace one cell and save its record (``<out_dir>/<arch>__<shape>__
    <mesh>.json``).  With ``time_limit_s`` the trace runs in a process of
    its own, killed past the limit (its record then says so): a trace
    cannot be interrupted inside the dispatcher."""
    mesh_name, dims, axes = MESHES[multi_pod]
    shape = SHAPES[shape_name]
    cfg = get_config(arch).resolve_for_tp(dims[-1])
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "ok"}
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skip", reason=reason)
        _save(rec, out_dir)
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: {reason}")
        return rec
    if time_limit_s:
        return _run_cell_child(rec, multi_pod, out_dir, device,
                               time_limit_s)

    rec["device"] = device
    if shape.kind != "train":
        rec["serve_weight_stationary"] = shape.kind == "decode"
    t0 = time.time()
    try:
        rl, tr = trace_cell(cfg, shape, dims, axes, arch=arch,
                            mesh_name=mesh_name, device=device,
                            donate=donate)
        t_trace = time.time() - t0
        mem = memory_of(tr)
        rec.update(
            roofline=rl.to_dict(), memory=mem,
            timings={"trace_s": t_trace},
            collective_calls=_keyed(tr.collective_calls),
            comm_counts=tr.comm_counts, k11_calls=tr.ops.get(K11_OP, 0))
        if tr.microbatches_traced:
            rec["microbatches_traced"] = list(tr.microbatches_traced)
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"peak={mem['peak_bytes']/1e9:.2f}GB "
              f"compute={rl.t_compute*1e3:.2f}ms "
              f"memory={rl.t_memory*1e3:.2f}ms "
              f"collective={rl.t_collective*1e3:.2f}ms "
              f"bottleneck={rl.bottleneck} (trace {t_trace:.0f}s)",
              flush=True)
    # harness reporter: any failure is recorded to the JSON record
    # (status/error/traceback) and printed, never dropped — repro: noqa[RPA001]
    except Exception as e:  # a failure here is a bug in the system
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"FAILED {type(e).__name__}: {e}", flush=True)
    _save(rec, out_dir)
    return rec


def _run_cell_child(rec: dict, multi_pod: bool, out_dir: str, device: str,
                    time_limit_s: float) -> dict:
    """:func:`run_cell` in a child process (``python -m
    repro_torch.launch.dryrun`` on the one cell), killed after
    ``time_limit_s``; the child's record, or an error record."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           rec["arch"], "--shape", rec["shape"], "--mesh",
           "multi" if multi_pod else "single", "--out", out_dir,
           "--device", device, "--time-limit", "0"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))] +
        [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
         if p])}
    t0 = time.time()
    try:
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=time_limit_s)
    except subprocess.TimeoutExpired:
        rec.update(status="error", device=device,
                   error=f"TimeoutError: the trace ran past its "
                         f"{time_limit_s:g} s limit",
                   timings={"trace_s": time.time() - t0})
        _save(rec, out_dir)
        print(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
              f"FAILED {rec['error']}", flush=True)
        return rec
    sys.stdout.write(out.stdout)
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    if out.returncode not in (0, 1) or not os.path.exists(path):
        rec.update(status="error", device=device,
                   error=f"the child exited {out.returncode}",
                   traceback=out.stderr[-4000:])
        _save(rec, out_dir)
        return rec
    with open(path) as f:
        return json.load(f)


def _save(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def analyze_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
                 unroll: bool = False, device: str = "cuda") -> None:
    """Augment an existing cell record with (a) the closed-form roofline
    terms (``launch/analytic.py``, the reference's keys) and (b),
    optionally, a trace of the cell with its layer pattern unrolled
    (``unrolled_cfg``: the reference's exact unrolled-HLO compile; the
    port's trace already runs every layer, so the two must agree)."""
    from .analytic import analytic_costs
    mesh_name, dims, axes = MESHES[multi_pod]
    chips = math.prod(dims)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    with open(path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        return
    shape = SHAPES[shape_name]
    cfg = get_config(arch).resolve_for_tp(dims[-1])
    cfg_a = cfg.replace(kv_quant=True) if shape.kind != "train" else cfg
    ac = analytic_costs(cfg_a, shape, chips, chips // dims[-1], dims[-1])
    t_c = ac.flops / PEAK_FLOPS_BF16
    t_m = ac.bytes / HBM_BW
    t_l = ac.collective_bytes / slowest_link(dims)
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    rec["analytic"] = {
        "flops_dev": ac.flops, "bytes_dev": ac.bytes,
        "collective_bytes_dev": ac.collective_bytes,
        "t_compute": t_c, "t_memory": t_m, "t_collective": t_l,
        "bottleneck": max(terms, key=terms.get),
        "model_flops_global": ac.detail["model_flops_global"],
        "useful_ratio": ac.detail["model_flops_global"] /
        (chips * ac.flops) if ac.flops else 0.0,
        "detail": ac.detail,
    }
    if unroll:
        try:
            rl, _ = trace_cell(unrolled_cfg(cfg), shape, dims, axes,
                               arch=arch, mesh_name=mesh_name,
                               device=device, memory=False, donate=False,
                               microbatches=1)
            rec["traced_unrolled"] = rl.to_dict()
        # analysis-only extra; the error lands in the record itself
        # repro: noqa[RPA001]
        except Exception as e:  # analysis-only; keep the base record
            rec["traced_unrolled"] = {"error": f"{type(e).__name__}: {e}"}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    a_bn = rec["analytic"]["bottleneck"]
    print(f"[analysis] {arch} x {shape_name} x {mesh_name}: "
          f"analytic compute={t_c*1e3:.2f}ms memory={t_m*1e3:.2f}ms "
          f"collective={t_l*1e3:.2f}ms bottleneck={a_bn}" +
          (" (+unrolled trace)" if unroll and
           "error" not in rec.get("traced_unrolled", {}) else ""))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (see repro_torch.configs.ARCH_IDS)")
    ap.add_argument("--shape", default="all",
                    help="shape cell or 'all' (train_4k, prefill_32k, "
                         "decode_32k, long_500k)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device", default="cuda",
                    help="device type the fake tensors claim (cuda or cpu)")
    ap.add_argument("--time-limit", type=float, default=0.0,
                    help="seconds a cell's trace may take, each cell then "
                         "in a process of its own (0: no limit, in this "
                         "process)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once (each in a process of its "
                         "own; needs --time-limit)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--analysis", action="store_true",
                    help="augment existing records with analytic terms "
                         "(+ an unrolled trace of decode cells)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = tuple(SHAPES) if args.shape == "all" else (args.shape,)
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]

    if args.analysis:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    p = os.path.join(args.out,
                                     f"{arch}__{shape}__{MESHES[mp][0]}.json")
                    if not os.path.exists(p):
                        continue
                    unroll = SHAPES[shape].kind == "decode" and not mp
                    analyze_cell(arch, shape, mp, args.out, unroll=unroll,
                                 device=args.device)
        return

    if args.jobs > 1 and not args.time_limit:
        ap.error("--jobs needs --time-limit (each cell in its own process)")
    results, todo = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = MESHES[mp][0]
                path = os.path.join(args.out,
                                    f"{arch}__{shape}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skip"):
                        print(f"[dryrun] {arch} x {shape} x {mesh_name}: "
                              "cached")
                        results.append(prev)
                        continue
                todo.append((arch, shape, mp))
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        results += pool.map(lambda c: run_cell(
            *c, args.out, device=args.device,
            time_limit_s=args.time_limit), todo)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip(design), {n_err} error")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
