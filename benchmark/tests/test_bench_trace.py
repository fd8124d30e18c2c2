"""The reduction of a profiler trace: the device's busy and idle time, the
attribution of device work to the spans that launched it, and the
breakdown, on a synthetic timeline."""

import numpy as np
import torch

from benchmark import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    """An event with the profiler's accessors (times in ns)."""

    def __init__(self, name, dev, start, dur, corr=0):
        self._n, self._d, self._s, self._u, self._c = name, dev, start, dur, corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def _timeline():
    return [
        Ev("bench.window", CPU, 0, 1000),
        Ev("runner.dispatch", CPU, 10, 500),
        Ev("stepper.relayout", CPU, 20, 100),
        Ev("runner.dispatch", CUDA, 15, 600),        # the span's GPU copy: not work
        Ev("cudaLaunchKernel", CPU, 30, 5, corr=1),
        Ev("cudaLaunchKernel", CPU, 200, 5, corr=2),
        Ev("cudaMemcpyAsync", CPU, 600, 5, corr=3),
        Ev("void cub::sort_kernel(int)", CUDA, 100, 200, corr=1),     # under relayout
        Ev("density_window_kernel(float4 const*)", CUDA, 250, 150, corr=2),
        Ev("Memcpy DtoH", CUDA, 700, 100, corr=3),
        Ev("stats.drain", CPU, 550, 300),
    ]


def test_busy_idle_and_attribution():
    tr = trace.Trace.from_events(_timeline())
    assert tr.window == (0, 1000) and tr.unlinked == 0
    assert len(tr.names) == 3                        # the span copy is dropped
    # busy: [100, 400) and [700, 800)
    assert tr.busy() == [(100, 400), (700, 800)]
    assert tr.busy_ns() == 400
    assert list(tr.under("stepper.relayout")) == [True, False, False]
    assert list(tr.under("runner.dispatch")) == [True, True, False]
    assert tr.count("runner.dispatch") == 1
    assert tr.device_ns(tr.under("stepper.relayout")) == 200
    assert list(tr.is_kernel) == [True, True, False]
    assert list(tr.span_ns("stats.drain")) == [300]
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "cub::sort_kernel"
    assert np.isclose(bd["device_ops"][0][1], 200e-9)
    # idle [0, 100): the host is in the window only; [400, 700): in the
    # dispatch; [800, 1000): in the stats drain
    gaps = dict((k, v) for k, v in bd["idle_gaps"])
    assert set(gaps) == {"bench.window", "runner.dispatch", "stats.drain"}
    assert np.isclose(gaps["bench.window"], 100e-9)
    assert np.isclose(gaps["runner.dispatch"], 300e-9)
    assert np.isclose(gaps["stats.drain"], 200e-9)


def test_idle_share_reader():
    import importlib.util

    from conftest import ROOT

    spec = importlib.util.spec_from_file_location(
        "idle", ROOT / "benchmark" / "metrics" / "device.idle_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Run:
        pass

    run = Run()
    run.trace = trace.Trace.from_events(_timeline())
    assert np.isclose(mod.read(run), 60.0)
    run.trace = None
    assert mod.read(run) is None


def test_union_of_overlapping_intervals():
    s = np.array([5, 0, 20, 8], np.int64)
    e = np.array([10, 6, 30, 9], np.int64)
    assert trace.union_ns(s, e, 2, 25) == [(2, 10), (20, 25)]
    assert trace.idle_gaps([(2, 10), (20, 25)], 0, 30) == [(0, 2), (10, 20), (25, 30)]
