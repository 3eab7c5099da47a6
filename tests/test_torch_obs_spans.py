"""The port's spans inside the program: the bind's steps (``plan.bind`` ⊃
``transform`` ⊃ ``transform.copy_out``, then ``bind.upload`` and
``bind.prepare``), a product's launch path (``matrix.spmv``), a flush's
steps on the card (``service.stack``, ``hybrid.block``, ``guard.probe``,
``service.unstack``), device spans on the host clock where there is no
card, the ``record_function`` range each span opens while telemetry is on,
and that telemetry changes no product and no container.

The file imports neither JAX nor the JAX package; its ``cuda`` tests run
on a machine with only PyTorch::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_obs_spans.py
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro_torch.obs as obs
from repro_torch.core.plan import Planner
from repro_torch.core.suite import synthesize_power_law
from repro_torch.core.transform import TRANSFORMS_HOST
from repro_torch.obs import FakeClock, InMemorySink, Span, Telemetry
from repro_torch.obs.tracing import NOOP_SPAN

#: the host recipes ``_traced`` wraps, with the parameters the planner
#: gives them
RECIPES = ("bcsr", "hybrid", "ccs", "coo_row", "coo_col", "ell_row",
           "ell_col", "sell")


@pytest.fixture()
def tel():
    """An enabled Telemetry on a FakeClock with an in-memory sink, the
    process default for the test."""
    t = Telemetry(enabled=True, clock=FakeClock(tick=1.0),
                  sinks=[InMemorySink()])
    prev = obs.set_default(t)
    yield t
    obs.set_default(prev)


def power_law(device="cpu", seed=1):
    """Rows of very different lengths (512 rows, 3 867 entries): the
    planners pick SELL buckets, and hybrid blocks of three formats."""
    return synthesize_power_law(n=512, seed=seed, random_values=True,
                                device=device)


def fresh(csr):
    """A new CSR object over the same arrays: a bind that cannot reuse the
    planner's materialized container, so it transforms."""
    return dataclasses.replace(csr)


def tree(tel):
    """``name -> [(span, parent name)]`` over the telemetry's spans."""
    by_id = {s.span_id: s for s in tel.spans}
    out = {}
    for s in tel.spans:
        parent = by_id.get(s.parent_id)
        out.setdefault(s.name, []).append(
            (s, parent.name if parent is not None else None))
    return out


def ancestors(tel, sp):
    by_id = {s.span_id: s for s in tel.spans}
    names = []
    while sp.parent_id is not None:
        sp = by_id[sp.parent_id]
        names.append(sp.name)
    return names


def same(a, b) -> bool:
    """Two containers (or tensors) equal bit for bit, field by field."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and torch.equal(a.cpu().contiguous().view(torch.uint8),
                                b.cpu().contiguous().view(torch.uint8)))
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            same(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


# ---------------------------------------------------------------------------
# the bind
# ---------------------------------------------------------------------------
def test_sell_bind_span_tree(tel):
    csr = power_law()
    plan = Planner(tier="kernel", device="cpu").plan(csr, fmt="sell")
    tel.reset()
    P = plan.bind(fresh(csr), device="cpu")
    t = tree(tel)
    assert [p for _, p in t["plan.bind"]] == [None]
    assert [p for _, p in t["transform"]] == ["plan.bind"]
    assert t["transform"][0][0].attrs["fmt"] == "sell"
    assert [p for _, p in t["transform.copy_out"]] == ["transform"]
    assert [p for _, p in t["bind.upload"]] == ["plan.bind"]
    assert [p for _, p in t["bind.prepare"]] == ["plan.bind"]
    order = [s.name for s in tel.spans]        # in the order they finished
    assert order.index("transform") < order.index("bind.upload") \
        < order.index("bind.prepare") < order.index("plan.bind")
    assert P.tiers["spmv"] == "kernel"


def test_hybrid_bind_span_tree(tel):
    csr = power_law()
    plan = Planner(tier="kernel", device="cpu").plan(csr,
                                                     partition="variance")
    assert plan.is_hybrid
    tel.reset()
    plan.bind(fresh(csr), device="cpu")
    t = tree(tel)
    assert [p for _, p in t["plan.bind"]] == [None]
    transforms = [s for s, _ in t["transform"]]
    assert transforms and all(p == "plan.bind" for _, p in t["transform"])
    copies = t["transform.copy_out"]
    # the source's one copy before the blocks are cut, then one inside
    # each block's recipe (the block is on the host: nothing to copy)
    assert [p for _, p in copies].count("plan.bind") == 1
    assert [p for _, p in copies].count("transform") == len(transforms)
    assert [p for _, p in t["bind.upload"]] == ["plan.bind"]
    assert [p for _, p in t["bind.prepare"]] == ["plan.bind"]


def test_one_matrix_span_a_product(tel):
    csr = power_law()
    P = Planner(tier="kernel", device="cpu").build(csr)
    x = torch.ones(csr.n_cols)
    tel.reset()
    for _ in range(3):
        P @ x
    P(x)
    P.spmm(torch.ones(csr.n_cols, 4))
    names = [s.name for s in tel.spans]
    assert names.count("matrix.spmv") == 4
    assert names.count("matrix.spmm") == 1
    assert all(s.clock == "host" for s in tel.spans)


# ---------------------------------------------------------------------------
# the flush
# ---------------------------------------------------------------------------
def test_flush_spans(tel):
    from repro_torch.serve import SpMVService
    csr = power_law()
    svc = SpMVService(max_batch=4, device="cpu", clock=FakeClock())
    entry = svc.register("m", csr, measure_baseline=False)
    n_blocks = len(entry.matrix.blocks)
    assert n_blocks > 1
    tel.reset()
    x = torch.ones(csr.n_cols)
    futs = [svc.submit("m", x) for _ in range(4)]      # one flush
    assert all(f.done() for f in futs)
    t = tree(tel)
    assert [p for _, p in t["service.flush"]] == [None]
    for name in ("service.stack", "guard.probe", "service.unstack"):
        assert [p for _, p in t[name]] == ["service.flush"], name
    blocks = [s for s, _ in t["hybrid.block"]]
    assert len(blocks) == n_blocks
    assert all("service.flush" in ancestors(tel, s) for s in blocks)
    assert [s.attrs["fmt"] for s in blocks] == list(entry.matrix.formats)
    assert sum(s.attrs["rows"] for s in blocks) == csr.n_rows
    assert sum(s.attrs["nnz"] for s in blocks) == csr.nnz
    order = [s.name for s in tel.spans if s.name != "hybrid.block"]
    assert order.index("service.stack") < order.index("guard.probe") \
        < order.index("service.unstack") < order.index("service.flush")
    # the flush's causes are read from its span by the CLI
    assert t["service.flush"][0][0].attrs == {"key": "m",
                                              "cause": "max_batch",
                                              "batch": 4}
    assert not [r for r in tel.sinks[0].events()
                if r["name"] == "service.flush"]


def test_summarize_reads_flush_causes_from_spans(tmp_path, capsys):
    from repro_torch.obs import JsonlSink
    from repro_torch.obs.cli import main
    from repro_torch.serve import SpMVService
    path = str(tmp_path / "run.jsonl")
    t = Telemetry(enabled=True, clock=FakeClock(), sinks=[JsonlSink(path)])
    prev = obs.set_default(t)
    try:
        csr = power_law()
        svc = SpMVService(max_batch=2, device="cpu", clock=FakeClock())
        svc.register("m", csr, measure_baseline=False)
        for _ in range(5):
            svc.submit("m", torch.ones(csr.n_cols))
        svc.flush("m")
    finally:
        obs.set_default(prev)
        t.close()
    assert main(["summarize", path]) == 0
    out = capsys.readouterr().out
    table = out[out.index("== service flushes =="):].splitlines()
    rows = {r.split()[0]: r.split()[1:] for r in table[3:] if r.strip()}
    assert rows["max_batch"] == ["2", "4"]
    assert rows["explicit"] == ["1", "1"]


# ---------------------------------------------------------------------------
# device spans without a card, and the disabled path
# ---------------------------------------------------------------------------
def test_device_span_on_a_cpu_tensor_is_a_host_span():
    t = Telemetry(enabled=True, sinks=[InMemorySink()])
    with t.span("service.stack", on=torch.zeros(3)) as sp:
        pass
    assert sp.clock == "host" and sp.events is None
    assert sp.dur >= 0.0
    rec = t.sinks[0].spans()[0]
    assert rec["clock"] == "host" and rec["dur"] == sp.dur
    assert t.to_chrome_trace()["traceEvents"][0]["args"]["clock"] == "host"


def test_device_span_with_a_fake_clock_never_touches_the_card(monkeypatch):
    def no_card(*a, **k):
        raise AssertionError("a FakeClock span reached CUDA")
    monkeypatch.setattr(torch.cuda, "current_stream", no_card)
    monkeypatch.setattr(torch.cuda, "Event", no_card)
    t = Telemetry(enabled=True, clock=FakeClock(tick=0.5))
    with t.span("hybrid.block", on=torch.device("cuda", 0), fmt="sell"):
        pass
    (sp,) = t.spans
    assert sp.clock == "host" and sp.dur == 0.5


def test_disabled_span_is_the_shared_noop():
    t = Telemetry(enabled=False)
    assert t.span("guard.probe", on=torch.zeros(2)) is NOOP_SPAN
    assert t.span("matrix.spmv") is NOOP_SPAN
    assert not t.spans


class FakeEvent:
    """A CUDA timing event's surface: done once ``synchronize`` ran or the
    test says so."""

    def __init__(self, ms=0.0):
        self.done = False
        self.ms = ms

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done, "read before the card passed the end"
        return end.ms


def test_device_span_records_wait_for_the_card_in_finishing_order():
    sink = InMemorySink()
    t = Telemetry(enabled=True, clock=FakeClock(start=10.0), sinks=[sink])
    end = FakeEvent(ms=2.5)
    sp = Span(name="service.stack", t_start=10.0, span_id=1,
              clock="device", events=(FakeEvent(), end))
    t._finish_span(sp)
    with t.span("matrix.spmv"):
        pass
    assert sink.records == []            # nothing waits, nothing is lost
    end.done = True
    with t.span("matrix.spmv"):
        pass
    assert [r["name"] for r in sink.records] == [
        "service.stack", "matrix.spmv", "matrix.spmv"]
    assert sink.records[0]["clock"] == "device"
    assert sink.records[0]["dur"] == pytest.approx(2.5e-3)
    late = Span(name="guard.probe", t_start=11.0, span_id=9,
                clock="device", events=(FakeEvent(), FakeEvent(ms=1.0)))
    t._finish_span(late)
    t.close()                            # close waits for the card
    assert sink.records[-1]["name"] == "guard.probe"
    assert sink.records[-1]["dur"] == pytest.approx(1e-3)


# ---------------------------------------------------------------------------
# torch.profiler ranges
# ---------------------------------------------------------------------------
def profiled_names(enabled):
    csr = power_law()
    plan = Planner(tier="kernel", device="cpu").plan(csr, fmt="sell")
    t = Telemetry(enabled=enabled)
    prev = obs.set_default(t)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            P = plan.bind(fresh(csr), device="cpu")
            P @ torch.ones(csr.n_cols)
    finally:
        obs.set_default(prev)
    return {e.name for e in prof.events()}


PROGRAM_RANGES = {"plan.bind", "transform", "transform.copy_out",
                  "bind.upload", "bind.prepare", "matrix.spmv"}


def test_record_function_ranges_while_on():
    assert PROGRAM_RANGES <= profiled_names(True)


def test_no_range_while_off():
    assert not PROGRAM_RANGES & profiled_names(False)


# ---------------------------------------------------------------------------
# telemetry changes nothing the program computes
# ---------------------------------------------------------------------------
def bound(enabled, how):
    csr = power_law()
    t = Telemetry(enabled=enabled, clock=FakeClock())
    prev = obs.set_default(t)
    try:
        planner = Planner(tier="kernel", device="cpu")
        plan = (planner.plan(csr, partition="variance") if how == "hybrid"
                else planner.plan(csr, fmt=how))
        P = plan.bind(fresh(csr), device="cpu")
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.normal(size=csr.n_cols).astype(np.float32))
        X = torch.from_numpy(
            rng.normal(size=(csr.n_cols, 8)).astype(np.float32))
        return P.matrix, P @ x, P @ X
    finally:
        obs.set_default(prev)


@pytest.mark.parametrize("how", ["sell", "ell_row", "csr", "hybrid"])
def test_products_and_containers_bitwise_on_and_off(how):
    m_off, y_off, Y_off = bound(False, how)
    m_on, y_on, Y_on = bound(True, how)
    assert same(m_on, m_off)
    assert same(y_on, y_off) and same(Y_on, Y_off)


@pytest.mark.parametrize("fmt", RECIPES)
def test_each_recipe_bitwise_on_and_off(fmt):
    csr = power_law(seed=3)
    off = TRANSFORMS_HOST[fmt](csr)
    t = Telemetry(enabled=True, clock=FakeClock())
    prev = obs.set_default(t)
    try:
        on = TRANSFORMS_HOST[fmt](csr)
    finally:
        obs.set_default(prev)
    assert same(on, off)
    assert [s.name for s in t.spans if s.parent_id is None] == ["transform"]


def test_service_answers_bitwise_on_and_off():
    from repro_torch.serve import SpMVService
    rng = np.random.default_rng(9)
    xs = [torch.from_numpy(rng.normal(size=512).astype(np.float32))
          for _ in range(6)]

    def answers(enabled):
        t = Telemetry(enabled=enabled, clock=FakeClock())
        prev = obs.set_default(t)
        try:
            csr = power_law()
            svc = SpMVService(max_batch=3, device="cpu", clock=FakeClock())
            svc.register("m", csr, measure_baseline=False)
            futs = [svc.submit("m", x) for x in xs]
            return [f.result() for f in futs], len(t.spans)
        finally:
            obs.set_default(prev)

    (on, n_on), (off, n_off) = answers(True), answers(False)
    assert n_off == 0 and n_on > 0
    assert all(same(a, b) for a, b in zip(on, off))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device spans time the card's "
                    "stream")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_span_matches_event_timing(cuda):
    a = torch.randn(4096, 4096, device=cuda)
    t = Telemetry(enabled=True)
    with t.span("warm-up", on=a):     # cuBLAS, the profiler's range ops
        a @ a
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    with t.span("work", on=a) as sp:
        for _ in range(8):
            a @ a
    e1.record()
    assert sp.clock == "device" and sp.events is not None
    torch.cuda.synchronize()
    ref = e0.elapsed_time(e1) * 1e-3
    assert sp.dur == pytest.approx(ref, rel=0.02, abs=50e-6), (sp.dur, ref)
    assert sp.events is None                       # resolved once
    assert t.to_chrome_trace()["traceEvents"][1]["args"]["clock"] == "device"


@pytest.mark.cuda
def test_spans_add_no_synchronize(cuda, monkeypatch):
    """The same bind, products and flush synchronize as often with
    telemetry on as off (the service's own synchronize after each
    product is the only one), and give the same bits (the plain CSR
    version's ``index_add_`` in its deterministic form on the card)."""
    from repro_torch.serve import SpMVService
    calls = {"n": 0}
    real = torch.cuda.synchronize

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    def run(enabled):
        t = Telemetry(enabled=enabled)
        prev = obs.set_default(t)
        monkeypatch.setattr(torch.cuda, "synchronize", counting)
        calls["n"] = 0
        try:
            csr = power_law(cuda)
            plan = Planner(tier="reference", device=cuda).plan(
                csr, partition="variance")
            P = plan.bind(fresh(csr), device=cuda)
            y = P @ torch.ones(csr.n_cols, device=cuda)
            svc = SpMVService(max_batch=4, device=cuda)
            svc.register("m", csr, measure_baseline=False)
            futs = [svc.submit("m", torch.ones(csr.n_cols, device=cuda))
                    for _ in range(4)]
            n = calls["n"]
        finally:
            monkeypatch.setattr(torch.cuda, "synchronize", real)
            obs.set_default(prev)
        real()
        return n, y, [f.result() for f in futs], t

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        n_off, y_off, a_off, _ = run(False)
        n_on, y_on, a_on, t = run(True)
    finally:
        torch.use_deterministic_algorithms(was)
    assert n_off > 0 and n_on == n_off    # the flush's own, counted
    assert same(y_on, y_off) and all(same(a, b) for a, b in zip(a_on, a_off))
    devs = {s.name for s in t.spans if s.clock == "device"}
    assert {"service.stack", "hybrid.block", "service.unstack"} <= devs
    assert all(s.dur >= 0.0 for s in t.spans)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", RECIPES)
def test_recipe_of_a_card_source_equals_a_host_source(cuda, fmt):
    """The hoisted copy-out: a recipe on a CSR on the card gives the
    container it gives on the same CSR on the host, bit for bit."""
    host = power_law(seed=3)
    assert same(TRANSFORMS_HOST[fmt](host.to(cuda)),
                TRANSFORMS_HOST[fmt](host))
