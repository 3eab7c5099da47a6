"""Port vs reference: the observability substrate, ``repro_torch.obs``.

Mirrors ``tests/test_obs.py`` on the port's copy of ``repro.obs``: metric
primitives, span nesting, exporters, the pipeline's emissions (service
counters, decision events, transform spans — the port's service, planner
and tuner on the CPU), the default-off contract, and the
``python -m repro_torch.obs`` CLI, which imports no array framework."""
import json
import math
import threading

import numpy as np
import pytest

import repro.obs as ref_obs
import repro_torch.obs as obs
from repro_torch.obs import (DEFAULT_LATENCY_EDGES, FakeClock, Histogram,
                             InMemorySink, JsonlSink, Telemetry, percentile,
                             prometheus_text, read_jsonl,
                             validate_chrome_trace)


@pytest.fixture()
def tel():
    """A fresh enabled Telemetry on a FakeClock, installed as the process
    default for the duration of the test."""
    t = Telemetry(enabled=True, clock=FakeClock(), sinks=[InMemorySink()])
    prev = obs.set_default(t)
    yield t
    obs.set_default(prev)


def sink_of(tel):
    return tel.sinks[0]


# ---------------------------------------------------------------------------
# histogram bucket edges
# ---------------------------------------------------------------------------
def test_default_edges_are_a_sorted_125_ladder():
    assert list(DEFAULT_LATENCY_EDGES) == sorted(DEFAULT_LATENCY_EDGES)
    assert len(set(DEFAULT_LATENCY_EDGES)) == len(DEFAULT_LATENCY_EDGES)
    assert DEFAULT_LATENCY_EDGES[0] == pytest.approx(1e-6)
    assert DEFAULT_LATENCY_EDGES[-1] == pytest.approx(50.0)
    assert 1e-3 in DEFAULT_LATENCY_EDGES and 2e-3 in DEFAULT_LATENCY_EDGES
    assert tuple(DEFAULT_LATENCY_EDGES) == \
        tuple(ref_obs.DEFAULT_LATENCY_EDGES)


def test_histogram_le_bucket_semantics():
    h = Histogram(edges=(1.0, 2.0, 5.0))
    for v in (0.5, 1.0, 1.5, 2.0, 4.0, 5.0, 100.0):
        h.observe(v)
    # le semantics: v == edge lands in that edge's bucket; one overflow
    assert h.counts == [2, 2, 2, 1]
    assert h.count == 7
    assert h.sum == pytest.approx(114.0)
    assert h.mean == pytest.approx(114.0 / 7)
    d = h.to_dict()
    assert d["edges"] == [1.0, 2.0, 5.0] and d["counts"] == h.counts


def test_histogram_quantiles_and_empty():
    h = Histogram(edges=(1.0, 2.0, 5.0))
    assert math.isnan(h.quantile(0.5)) and math.isnan(h.mean)
    for _ in range(100):
        h.observe(1.5)
    # every sample in (1, 2]: any quantile interpolates inside that bucket
    assert 1.0 <= h.quantile(0.5) <= 2.0
    assert 1.0 <= h.quantile(0.99) <= 2.0
    h2 = Histogram(edges=(1.0,))
    h2.observe(10.0)                       # overflow clamps to last edge
    assert h2.quantile(0.5) == pytest.approx(1.0)
    s = h.summary()
    assert s["count"] == 100 and set(s) >= {"p50", "p90", "p99", "mean"}


def test_histogram_rejects_degenerate_edges():
    with pytest.raises(ValueError):
        Histogram(edges=())
    with pytest.raises(ValueError):
        Histogram(edges=(1.0, 1.0))


def test_percentile_exact_interpolation():
    assert percentile([4.0, 1.0, 3.0, 2.0], 0.5) == pytest.approx(2.5)
    assert percentile([1.0], 0.9) == 1.0
    assert math.isnan(percentile([], 0.5))


# ---------------------------------------------------------------------------
# counters / gauges / registry
# ---------------------------------------------------------------------------
def test_metric_registry_label_identity(tel):
    tel.counter("c", a=1, b=2).inc()
    tel.counter("c", b=2, a=1).inc(2.0)     # label order is irrelevant
    tel.counter("c", a=1).inc()             # different label set: new metric
    snap = tel.snapshot()
    assert snap["counters"]["c{a=1,b=2}"] == 3.0
    assert snap["counters"]["c{a=1}"] == 1.0
    tel.gauge("g").set(5)
    tel.gauge("g").inc(-2)
    assert tel.snapshot()["gauges"]["g"] == 3.0


# ---------------------------------------------------------------------------
# span nesting + attribute propagation
# ---------------------------------------------------------------------------
def test_span_nesting_parent_ids_and_attrs(tel):
    clk = tel.clock
    with tel.span("outer", fmt="sell") as outer:
        clk.advance(0.5)
        with tel.span("inner") as inner:
            clk.advance(0.25)
            inner.set(nnz=9)
    assert [s.name for s in tel.spans] == ["inner", "outer"]
    inner_s, outer_s = tel.spans
    assert inner_s.parent_id == outer_s.span_id
    assert outer_s.parent_id is None
    assert outer_s.dur == pytest.approx(0.75)
    assert inner_s.dur == pytest.approx(0.25)
    assert outer_s.attrs == {"fmt": "sell"}
    assert inner_s.attrs == {"nnz": 9}
    # a new root span after the stack unwound has no parent
    with tel.span("root2"):
        pass
    assert tel.spans[-1].parent_id is None


def test_span_stack_is_per_thread(tel):
    seen = {}

    def worker():
        with tel.span("in_thread"):
            pass
        seen["done"] = True

    with tel.span("main_span"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    by_name = {s.name: s for s in tel.spans}
    assert seen["done"]
    # the worker's span must not be parented to the main thread's span
    assert by_name["in_thread"].parent_id is None
    assert by_name["in_thread"].tid != by_name["main_span"].tid


def test_event_parents_to_open_span(tel):
    with tel.span("s") as sp:
        tel.event("ev", k=1)
    assert tel.events[0]["span_id"] == sp.span_id
    tel.event("orphan")
    assert tel.events[1]["span_id"] is None


def test_bounded_buffers_count_drops():
    t = Telemetry(enabled=True, clock=FakeClock(), max_records=2)
    for i in range(5):
        t.event(f"e{i}")
    assert len(t.events) == 2 and t.dropped == 3
    assert t.snapshot()["dropped"] == 3


# ---------------------------------------------------------------------------
# chrome trace export + schema validation
# ---------------------------------------------------------------------------
def test_chrome_trace_schema(tel):
    clk = tel.clock
    with tel.span("tune.sweep", fmt="ell_row"):
        clk.advance(0.001)
        with tel.span("tune.candidate", geometry={"block_rows": 8}):
            clk.advance(0.002)
    ct = tel.to_chrome_trace()
    assert validate_chrome_trace(ct) == []
    assert ct["displayTimeUnit"] == "ms"
    evs = {e["name"]: e for e in ct["traceEvents"]}
    cand = evs["tune.candidate"]
    assert cand["ph"] == "X" and cand["cat"] == "tune"
    assert cand["dur"] == pytest.approx(2000.0)      # seconds -> us
    assert cand["args"]["geometry"] == {"block_rows": 8}
    assert cand["args"]["parent_id"] == evs["tune.sweep"]["args"]["span_id"]
    # the export must be strict-JSON serializable end to end
    json.loads(json.dumps(ct))


def test_validate_chrome_trace_rejects_malformed():
    assert validate_chrome_trace([]) != []
    assert validate_chrome_trace({}) != []
    bad = {"traceEvents": [{"name": 3, "ph": "X", "ts": 0, "dur": 0,
                            "pid": 1, "tid": 1}]}
    assert any("name" in e for e in validate_chrome_trace(bad))
    bad = {"traceEvents": [{"name": "a", "ph": "Q", "ts": 0,
                            "pid": 1, "tid": 1}]}
    assert any("phase" in e for e in validate_chrome_trace(bad))
    bad = {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "dur": None,
                            "pid": 1, "tid": 1}]}
    assert any("dur" in e for e in validate_chrome_trace(bad))


def test_numpy_attrs_become_jsonable(tel):
    with tel.span("s", n=np.int64(7), t=np.float32(0.5),
                  arr=(np.int32(1), np.int32(2))):
        pass
    rec = tel.spans[0].to_record()
    json.dumps(rec)  # must not raise
    assert rec["attrs"]["n"] == 7
    assert rec["attrs"]["arr"] == [1, 2]


# ---------------------------------------------------------------------------
# sinks + prometheus exposition
# ---------------------------------------------------------------------------
def test_jsonl_sink_roundtrip(tmp_path):
    p = str(tmp_path / "events.jsonl")
    t = Telemetry(enabled=True, clock=FakeClock(), sinks=[JsonlSink(p)])
    with t.span("transform", fmt="ccs"):
        pass
    t.event("plan.decision", rule="paper", fmt="ccs")
    t.close()
    recs = read_jsonl(p)
    assert [r["type"] for r in recs] == ["span", "event"]
    assert recs[1]["attrs"]["rule"] == "paper"


def test_read_jsonl_raises_with_line_number(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"ok": 1}\nnot json\n')
    with pytest.raises(ValueError, match=":2"):
        read_jsonl(str(p))


def test_sink_errors_are_swallowed_and_counted():
    class Exploding:
        def emit(self, rec):
            raise RuntimeError("boom")

    t = Telemetry(enabled=True, clock=FakeClock(), sinks=[Exploding()])
    with t.span("s"):
        pass
    t.event("e")
    assert t.sink_errors == 2
    assert len(t.spans) == 1           # the bounded buffer still got it


def test_prometheus_text_exposition(tel):
    tel.counter("service.flush", cause="deadline").inc(3)
    tel.gauge("service.queue_depth", key="m").set(2)
    h = tel.histogram("lat", edges=(0.001, 0.01))
    for v in (0.0005, 0.005, 0.5):
        h.observe(v)
    text = prometheus_text(tel)
    assert "# TYPE service_flush counter" in text
    assert 'service_flush{cause="deadline"} 3' in text
    assert 'service_queue_depth{key="m"} 2' in text
    assert "# TYPE lat histogram" in text
    assert 'lat_bucket{le="0.001"} 1' in text
    assert 'lat_bucket{le="0.01"} 2' in text       # cumulative
    assert 'lat_bucket{le="+Inf"} 3' in text
    assert "lat_count 3" in text
    # the JAX package's exporter writes the same text for the same metrics
    ref = ref_obs.Telemetry(enabled=True, clock=ref_obs.FakeClock())
    ref.counter("service.flush", cause="deadline").inc(3)
    ref.gauge("service.queue_depth", key="m").set(2)
    rh = ref.histogram("lat", edges=(0.001, 0.01))
    for v in (0.0005, 0.005, 0.5):
        rh.observe(v)
    assert ref_obs.prometheus_text(ref) == text


# ---------------------------------------------------------------------------
# default-off contract
# ---------------------------------------------------------------------------
def test_disabled_telemetry_is_inert():
    t = Telemetry()                      # enabled=False is the default
    with t.span("s") as sp:
        sp.set(a=1)                      # noop span accepts set()
    t.event("e")
    assert t.spans == [] and t.events == []
    assert t.span("x") is t.span("y")    # the shared NOOP_SPAN singleton


def test_enable_disable_roundtrip():
    prev = obs.set_default(Telemetry())
    try:
        assert not obs.enabled()
        sink = InMemorySink()
        obs.enable(sink=sink, clock=FakeClock())
        assert obs.enabled()
        with obs.span("s"):
            obs.event("e")
        assert len(sink.records) == 2
        obs.disable()
        with obs.span("t"):
            pass
        assert len(sink.records) == 2    # nothing new after disable
    finally:
        obs.set_default(prev)


# ---------------------------------------------------------------------------
# pipeline emissions (service counters via in-memory sink + fake clock)
# ---------------------------------------------------------------------------
@pytest.fixture()
def service_problem():
    from repro_torch.core.transform import csr_from_dense
    rng = np.random.default_rng(7)
    dense = (rng.random((48, 40)) < 0.15).astype(np.float32)
    return dense, csr_from_dense(dense, pad=8, device="cpu")


def test_service_emits_counters_histograms_and_flush_causes(
        tel, service_problem):
    from repro_torch.serve import SpMVService

    _, csr = service_problem
    clk = FakeClock()
    svc = SpMVService(max_batch=2, deadline_ms=1.0, clock=clk,
                      device="cpu")
    svc.register("m", csr, measure_baseline=False)
    x = np.ones((csr.n_cols,), np.float32)
    svc.spmv("m", x)
    svc.spmm("m", np.ones((csr.n_cols, 3), np.float32))
    svc.submit("m", x)
    svc.submit("m", x)                    # hits max_batch=2
    svc.submit("m", x)
    clk.advance(0.005)
    svc.poll()                            # deadline flush
    svc.submit("m", x)
    svc.flush("m")                        # explicit flush
    snap = tel.snapshot()
    assert snap["counters"]["service.flush{cause=max_batch,key=m}"] == 1.0
    assert snap["counters"]["service.flush{cause=deadline,key=m}"] == 1.0
    assert snap["counters"]["service.flush{cause=explicit,key=m}"] == 1.0
    assert snap["histograms"][
        "service.query_latency_s{key=m,op=spmv}"]["count"] == 1
    assert snap["histograms"][
        "service.query_latency_s{key=m,op=spmm}"]["count"] == 1
    assert snap["gauges"]["service.queue_depth{key=m}"] == 0.0
    # the flush's causes are on its span (the port emits no flush event)
    causes = {e["attrs"]["cause"]
              for e in sink_of(tel).named("service.flush")
              if e["type"] == "span"}
    assert causes == {"max_batch", "deadline", "explicit"}
    assert not [e for e in sink_of(tel).named("service.flush")
                if e["type"] == "event"]
    # stats() folds this key's telemetry slice in
    st = svc.stats()["m"]
    assert st["telemetry"]["service.flush{cause=explicit}"] == 1.0
    assert st["telemetry"][
        "service.query_latency_s{op=spmv}"]["count"] == 1
    # register span carries the build
    names = [s["name"] for s in sink_of(tel).spans()]
    assert "service.register" in names


def test_service_plan_replay_hit_and_miss(tel, service_problem):
    from repro_torch.serve import SpMVService

    _, csr = service_problem
    svc = SpMVService(max_batch=4, device="cpu")
    entry = svc.register("m", csr, measure_baseline=False)
    plan = entry.plan
    assert plan is not None
    svc.register("m2", csr, plan=plan,
                 measure_baseline=False)                  # fingerprint hit
    other = np.eye(8, dtype=np.float32)
    from repro_torch.core.transform import csr_from_dense
    svc.register("m3", csr_from_dense(other, pad=8, device="cpu"), plan=plan,
                 measure_baseline=False)                  # miss
    snap = tel.snapshot()
    assert snap["counters"]["service.plan_replay{hit=True,key=m2}"] == 1.0
    assert snap["counters"]["service.plan_replay{hit=False,key=m3}"] == 1.0
    replays = [e for e in sink_of(tel).named("service.plan_replay")
               if e["type"] == "event"]
    assert {(e["attrs"]["key"], e["attrs"]["hit"]) for e in replays} == \
        {("m2", True), ("m3", False)}


def test_decisions_transforms_and_dispatch_emit(tel, service_problem):
    from repro_torch.core.dispatch import resolve_impl
    from repro_torch.core.plan import Planner
    from repro_torch.core.transform import TRANSFORMS_HOST

    _, csr = service_problem
    plan = Planner(device="cpu").plan(csr)
    TRANSFORMS_HOST["ccs"](csr)
    resolve_impl("ell_row", "spmv", tier="reference")
    snap = tel.snapshot()
    decision_keys = [k for k in snap["counters"] if "plan.decisions" in k]
    assert decision_keys, snap["counters"]
    assert any(k.startswith("dispatch.resolve{fmt=ell_row")
               for k in snap["counters"])
    tr = [s for s in sink_of(tel).spans() if s["name"] == "transform"]
    assert any(s["attrs"]["fmt"] == "ccs" for s in tr)
    pl = [s for s in sink_of(tel).spans() if s["name"] == "plan.plan"]
    assert pl and pl[0]["attrs"]["fmt"] == plan.fmt


def test_tuner_emits_candidate_spans_and_winner_events(tel):
    from repro_torch.core.kernel_tune import KernelTuner
    from repro_torch.core.transform import csr_from_dense

    def fake_timer(thunk, g):
        return 1.0 if g is None else 0.5

    rng = np.random.default_rng(3)
    dense = (rng.random((32, 32)) < 0.2).astype(np.float32)
    csr = csr_from_dense(dense, pad=8, device="cpu")
    tuner = KernelTuner(timer=fake_timer, interpret=True, max_candidates=3)
    rec = tuner.tune(csr, op="spmv")
    cands = [s for s in sink_of(tel).spans()
             if s["name"] == "tune.candidate"]
    assert len(cands) >= 2                      # default + >=1 candidate
    assert all(s["attrs"]["fmt"] == "csr" for s in cands)
    assert all("t" in s["attrs"] for s in cands)
    sweeps = [s for s in sink_of(tel).spans() if s["name"] == "tune.sweep"]
    assert len(sweeps) == 1
    assert sweeps[0]["attrs"]["candidates"] == len(cands)
    winners = [e for e in sink_of(tel).named("tune.winner")
               if e["type"] == "event"]
    assert len(winners) == 1
    assert winners[0]["attrs"]["t_best"] == pytest.approx(rec.t_best)
    assert winners[0]["attrs"]["geometry"] == rec.geometry.to_dict()
    # memo hit: no new sweep, but the hit counter moves
    tuner.tune(csr, op="spmv")
    assert len([s for s in sink_of(tel).spans()
                if s["name"] == "tune.sweep"]) == 1
    assert tel.snapshot()["counters"]["tune.memo_hit{fmt=csr,op=spmv}"] == 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.fixture()
def trace_files(tmp_path):
    """A JSONL stream + chrome trace + two plan JSONs for the CLI."""
    from repro_torch.obs import save_chrome_trace

    clk = FakeClock()
    jsonl = str(tmp_path / "run.jsonl")
    t = Telemetry(enabled=True, clock=clk, sinks=[JsonlSink(jsonl)])
    with t.span("offline.matrix", matrix="m1"):
        clk.advance(0.01)
        t.event("offline.measure", matrix="m1", fmt="ell_row", batch=1,
                t_crs=1e-4, t_f=5e-5, t_trans=1e-3, r=2.0)
    t.event("plan.decision", rule="paper", fmt="ell_row", d_mat=0.4,
            d_star=1.1)
    t.event("tune.winner", fmt="ell_row", op="spmv", batch=1, t_best=4e-5,
            t_default=6e-5, speedup=1.5, geometry={"block_rows": 8})
    with t.span("service.flush", cause="deadline", key="m1", batch=4):
        pass
    t.event("service.plan_replay", key="m1", hit=True)
    t.close()
    trace = str(tmp_path / "run.trace.json")
    save_chrome_trace(t, trace)
    plan_a = {"schema_version": 3, "fmt": "ell_row", "rule": "paper",
              "tier": "kernel", "batch": 1, "d_mat": 0.4,
              "transform": {"name": "ell_row", "params": {}},
              "geometry": {"spmv": {"block_rows": 8}}}
    plan_b = {**plan_a, "fmt": "sell",
              "transform": {"name": "sell", "params": {"slice_rows": 64}}}
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    json.dump(plan_a, open(pa, "w"))
    json.dump(plan_b, open(pb, "w"))
    return {"jsonl": jsonl, "trace": trace, "plan_a": pa, "plan_b": pb}


def test_cli_summarize(trace_files, capsys):
    from repro_torch.obs.cli import main
    assert main(["summarize", trace_files["jsonl"]]) == 0
    out = capsys.readouterr().out
    assert "offline.matrix" in out and "plan decisions" in out
    assert "tune winners" in out and "deadline" in out
    assert "1 hit / 0 miss" in out


def test_cli_validate(trace_files, tmp_path, capsys):
    from repro_torch.obs.cli import main
    assert main(["validate", trace_files["trace"]]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text('{"traceEvents": [{"ph": "X"}]}')
    assert main(["validate", str(bad)]) == 1


def test_cli_plan_and_diff(trace_files, capsys):
    from repro_torch.obs.cli import main
    assert main(["plan", trace_files["plan_a"]]) == 0
    out = capsys.readouterr().out
    assert "ell_row" in out and "geometry.spmv" in out
    assert main(["diff", trace_files["plan_a"], trace_files["plan_b"]]) == 1
    out = capsys.readouterr().out
    assert "transform.params.slice_rows" in out
    assert main(["diff", trace_files["plan_a"], trace_files["plan_a"]]) == 0


def test_cli_is_framework_free():
    import os
    import subprocess
    import sys
    code = ("import sys; import repro_torch.obs.cli, repro_torch.obs; "
            "bad = [m for m in ('torch', 'jax') if m in sys.modules]; "
            "assert not bad, bad")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode == 0, proc.stderr
