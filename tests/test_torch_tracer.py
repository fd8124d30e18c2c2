"""The port's tracer (utils/tracer.py) on the CPU.  Off, it records nothing
and a drop through SimRunner ends bitwise where it ends with tracing on.
On, that run gives the span tree of the runner's layers: nesting, counts,
dispatch numbers and order.  Its times lie on the profiler's timeline, and
its Chrome export loads."""

import json
import time

import pytest
import torch

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch.io.gravity import ConstantGravity
from pi_sph_fluid_tpu_torch.utils.tracer import tracer

torch.set_num_threads(1)

CFG = T.SPHConfig()
KW = dict(tq=32, qb=8, cap=256, seg_q=2)
K, R, D = 8, 4, 3          # ticks a dispatch, resort period, dispatches
SETUP = ("runner.build", "runner.prime", "runner.settle")


class ListSink:
    def __init__(self):
        self.frames = []

    def push(self, fb):
        self.frames.append(fb)


@pytest.fixture
def fresh():
    """The process's tracer, off and empty before and after the test."""
    tracer.disable()
    tracer.clear()
    yield tracer
    tracer.disable()
    tracer.clear()


def _drop_run(on: bool):
    """The 269 drop through SimRunner on the CPU: build, prime, a damped
    settle of K exact ticks, then D dispatches of K ticks at resort period
    R, each with a frame, pushed one dispatch late."""
    if on:
        tracer.enable()
    fluid, braw = T.build_drop_scene(CFG, "cpu")
    runner = T.SimRunner(CFG, fluid, braw, backend="window", device="cpu",
                         engine_opts=dict(KW), resort_every=R, render_shape=(16, 32))
    sink = ListSink()
    res = runner.run(ConstantGravity(CFG), sink, sim_seconds=D * K * CFG.dt,
                     steps_per_dispatch=K, settle_seconds=K * CFG.dt)
    assert res.dispatches == D and res.recoveries == 0
    return res, sink


@pytest.fixture(scope="module")
def traced():
    """The spans of one traced drop run."""
    tracer.disable()
    tracer.clear()
    try:
        _drop_run(on=True)
        return tracer.snapshot()["spans"]
    finally:
        tracer.disable()
        tracer.clear()


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_on_changes_nothing(fresh):
    off, off_sink = _drop_run(on=False)
    assert fresh.spans == [] and fresh.span("x") is fresh.span("y")
    on, on_sink = _drop_run(on=True)
    assert len(fresh.spans) > 0
    for a, b in zip(off.sim, on.sim):
        assert torch.equal(a, b)
    assert len(off_sink.frames) == len(on_sink.frames) == D
    assert all((a == b).all() for a, b in zip(off_sink.frames, on_sink.frames))


def test_counters_count_with_spans_off(fresh):
    fresh.count("probe.x")
    fresh.count("probe.x", 2)
    assert fresh.counters["probe.x"] == 3 and fresh.spans == []


def test_span_tree_nests_as_the_layers_call(traced):
    spans = traced
    assert all(0 <= s.start_ns <= s.end_ns for s in spans)
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    run = spans.index(_named(spans, "runner.run")[0])
    parent = {"runner.prime": "runner.run", "runner.settle": "runner.run",
              "runner.dispatch": "runner.run", "render.frame": "runner.dispatch",
              "runner.frame_fetch": "runner.run", "runner.sink": "runner.run",
              "stats.drain": "runner.run"}
    for name, up in parent.items():
        assert {spans[s.parent].name for s in _named(spans, name)} == {up}, name
    assert spans[run].parent == -1 and _named(spans, "runner.build")[0].parent == -1
    # every relayout lies in the prime, the settle or a dispatch, each in the run
    ups = [spans[s.parent].name for s in _named(spans, "stepper.relayout")]
    assert set(ups) == {"runner.prime", "runner.settle", "runner.dispatch"}
    assert all(spans[spans[s.parent].parent].name == "runner.run"
               for s in _named(spans, "stepper.relayout"))


def test_span_counts_follow_dispatches_and_resort_period(traced):
    spans = traced
    counts = {n: len(_named(spans, n)) for n in (
        "runner.build", "runner.run", "runner.prime", "runner.settle", "runner.dispatch",
        "render.frame", "runner.frame_fetch", "runner.sink", "stepper.relayout")}
    assert counts == {"runner.build": 1, "runner.run": 1, "runner.prime": 1,
                      "runner.settle": 1, "runner.dispatch": D, "render.frame": D,
                      "runner.frame_fetch": D, "runner.sink": D,
                      # D * K / R in the dispatches, one in the prime, K exact
                      # ticks in the settle
                      "stepper.relayout": D * K // R + 1 + K}
    assert len(_named(spans, "stats.drain")) >= 1
    by_dispatch = [s.dispatch for s in _named(spans, "stepper.relayout") if s.dispatch >= 0]
    assert by_dispatch == sorted(by_dispatch) and len(by_dispatch) == D * K // R


def test_dispatch_numbers_and_set_up_order(traced):
    spans = traced
    disp = _named(spans, "runner.dispatch")
    assert [s.dispatch for s in disp] == list(range(D))
    # a span opened inside a dispatch carries its number
    for i, s in enumerate(spans):
        j = s.parent
        while j >= 0 and spans[j].name != "runner.dispatch":
            j = spans[j].parent
        if j >= 0:
            assert s.dispatch == spans[j].dispatch, (i, s.name)
    # frame i is fetched and shown after dispatch i + 1 is queued (the last
    # one after the loop) and names dispatch i
    for name in ("runner.frame_fetch", "runner.sink"):
        shown = _named(spans, name)
        assert [s.dispatch for s in shown] == list(range(D))
        for s in shown[:-1]:
            assert s.start_ns >= disp[s.dispatch + 1].end_ns
    # set-up carries -1 and ends before the first dispatch opens
    setup = [s for s in spans if s.name in SETUP]
    assert {s.name for s in setup} == set(SETUP)
    for s in setup:
        assert s.dispatch == -1 and s.end_ns <= disp[0].start_ns
    for s in spans:
        if s.parent >= 0 and spans[s.parent].name in SETUP:
            assert s.dispatch == -1


def test_spans_lie_on_the_profiler_timeline(fresh):
    """A program span opened inside a record_function lies inside that
    event's interval on the CPU profiler's timeline, within 50 us."""
    fresh.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with torch.profiler.record_function("outer"):
                with fresh.span("inner"):
                    time.sleep(0.002)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer"]
    spans = _named(fresh.spans, "inner")
    assert len(events) == len(spans) == 3
    for e, s in zip(sorted(events, key=lambda e: e.start_ns()), spans):
        lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
        assert s.end_ns - s.start_ns >= 2_000_000
        assert lo - 50_000 <= s.start_ns and s.end_ns <= hi + 50_000, (lo, hi, s)


def test_to_chrome_writes_one_event_a_span(fresh, tmp_path):
    fresh.enable()
    with fresh.span("a", cap=384):
        with fresh.span("b", dispatch=7):
            pass
    fresh.count("kernel.density.launches", 2)
    path = tmp_path / "spans.json"
    fresh.to_chrome(path)
    doc = json.loads(path.read_text())
    ev = doc["traceEvents"]
    assert [e["name"] for e in ev] == ["a", "b"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ev)
    assert ev[0]["args"] == {"index": 0, "parent": -1, "dispatch": -1, "cap": 384}
    assert ev[1]["args"] == {"index": 1, "parent": 0, "dispatch": 7}
    assert ev[0]["ts"] == fresh.spans[0].start_ns / 1e3
    assert doc["otherData"]["counters"] == {"kernel.density.launches": 2}
