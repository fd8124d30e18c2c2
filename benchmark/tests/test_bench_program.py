"""The readers of the port's own spans and of the CUDA runtime's
synchronisation calls (program.py and its five metrics) on a synthetic
timeline, and two of them through the harness on the CPU."""

import importlib.util

import numpy as np
import pytest
from test_bench_trace import CPU, CUDA, Ev

from benchmark import program, trace
from conftest import ROOT, run_cpu
from pi_sph_fluid_tpu_torch.utils.tracer import Span


def _events():
    """A profiler window [1000, 2000) with runtime calls: the syncs at 1100,
    1150 and 1600 fall in relayouts, 1300 in a dispatch only, 1950 in
    neither; cudaMemcpyAsync and cudaLaunchKernel do not block."""
    return [
        Ev("bench.window", CPU, 1000, 1000),
        Ev("cudaLaunchKernel", CPU, 1060, 5, corr=1),
        Ev("void cub::sort_kernel(int)", CUDA, 1070, 20, corr=1),
        Ev("cudaStreamSynchronize", CPU, 1100, 20),
        Ev("cudaStreamSynchronize", CPU, 1150, 20),
        Ev("cudaMemcpyAsync", CPU, 1160, 5),
        Ev("cudaMemcpy", CPU, 1300, 10),
        Ev("cudaEventSynchronize", CPU, 1600, 10),
        Ev("cudaDeviceSynchronize", CPU, 1950, 10),
        Ev("stepper.relayout", CUDA, 1055, 100),     # a span's GPU copy
    ]


def _spans():
    """The port's spans: set-up (a build, a pre-roll run with its prime, the
    kernel load inside it, a settle and dispatch 0), then the window's run
    with dispatches 1 and 2, a relayout each, and a drain."""
    rows = [("runner.build", 0, 100, -1, -1), ("runner.run", 120, 900, -1, -1),
            ("runner.prime", 130, 300, 1, -1), ("kernels.load", 200, 260, 2, -1),
            ("runner.settle", 300, 500, 1, -1), ("runner.dispatch", 600, 800, 1, 0),
            ("runner.run", 1010, 1990, -1, -1), ("runner.dispatch", 1020, 1400, 6, 1),
            ("stepper.relayout", 1050, 1200, 7, 1), ("runner.dispatch", 1500, 1900, 6, 2),
            ("stepper.relayout", 1550, 1650, 9, 2), ("stats.drain", 1920, 1980, 6, 2)]
    return [Span(n, s, e, p, d, {}) for n, s, e, p, d in rows]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    def __init__(self, tr):
        self.trace = tr


def test_from_events_keeps_the_syncs_and_the_rest():
    tr = trace.Trace.from_events(_events())
    assert list(tr.syncs) == [1100, 1150, 1300, 1600, 1950]
    assert tr.window == (1000, 2000) and len(tr.names) == 1 and tr.unlinked == 0
    assert list(tr.launch) == [1060]
    assert [program.is_sync(n) for n in ("cudaMemcpy2D", "cudaMemcpyAsync",
                                         "cudaStreamSynchronize", "cudaLaunchKernel")] \
        == [True, False, True, False]


@pytest.mark.parametrize("name, value", [
    ("setup.build_s", 270e-9),             # build 100 + prime 170; the load nests
    ("setup.settle_s", 200e-9),
    ("relayout.syncs_per_relayout", 1.5),  # 3 syncs in 2 relayouts
    ("runner.syncs_per_dispatch", 2.0),    # 4 syncs in dispatches 1 and 2
    ("runner.dispatch_host_ms", 390e-6),   # (380 + 400) / 2 ns
])
def test_readers_on_a_synthetic_timeline(monkeypatch, name, value):
    read = _reader(name)
    run = Run(trace.Trace.from_events(_events()))
    monkeypatch.setattr(program, "spans", _spans)
    assert np.isclose(read(run), value, rtol=1e-12, atol=0)
    # nothing to read: a port without the tracer, or no trace
    monkeypatch.setattr(program, "spans", lambda: None)
    assert read(run) is None


def test_sync_readers_need_recorded_syncs(monkeypatch):
    """A trace with no runtime synchronisation at all (no CUDA activity)
    reads None, not 0."""
    monkeypatch.setattr(program, "spans", _spans)
    run = Run(trace.Trace.from_events([e for e in _events() if "Synchronize" not in e.name()
                                        and e.name() != "cudaMemcpy"]))
    assert _reader("relayout.syncs_per_relayout")(run) is None
    assert _reader("runner.syncs_per_dispatch")(run) is None
    assert np.isclose(_reader("runner.dispatch_host_ms")(run), 390e-6)


def test_span_readers_through_the_harness_on_the_cpu():
    """A traced drop on the CPU: the port's spans give the set-up and the
    dispatch readings; the CPU profiler records no runtime call, so the
    sync readings are absent."""
    res = run_cpu("drop_269.still", trace=True)
    m = res["metrics"]
    assert m["setup.build_s"]["value"] > 0 and m["setup.build_s"]["unit"] == "s"
    assert m["runner.dispatch_host_ms"]["value"] > 0
    assert "runner.syncs_per_dispatch" not in m and "setup.settle_s" not in m
    assert "render.host_ms_per_frame" in m
