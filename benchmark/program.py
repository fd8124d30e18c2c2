"""The port's own spans (``pi_sph_fluid_tpu_torch.utils.tracer``) and the
CUDA runtime's synchronisation calls of a traced run, for the per-layer
readers that read them.

run.py loads a ``--trace 1`` run's readers before the harness builds the
runner, and each reader of the port's spans calls ``begin()`` as it loads:
that empties the port's tracer and turns it on, so the record holds this
run's set-up as well as its window.  An untraced run loads no per-layer
reader and runs with the tracer off.  A port without the tracer records
nothing, and every reading here is None.

Loading this module also extends ``trace.Trace.from_events`` to keep the
host start time of every runtime synchronisation call as ``Trace.syncs``
(sorted, ns on the profiler's clock, where the tracer puts its spans too):
cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize and the
synchronous cudaMemcpy calls (those without ``Async``).  Everything
``from_events`` returned before is unchanged.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

trace = importlib.import_module("benchmark.trace")

__all__ = ["begin", "spans", "is_sync", "in_window", "setup_build_s", "settle_s",
           "syncs_per_span", "mean_ms"]

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
# the spans of set-up that build what the window runs
BUILD = ("runner.build", "kernels.load", "runner.prime")

try:
    from pi_sph_fluid_tpu_torch.utils.tracer import tracer as TRACER
except ImportError:       # a port from before the tracer
    TRACER = None


def is_sync(name: str) -> bool:
    """A CUDA runtime call that blocks the host until the device catches up."""
    return name in SYNC_CALLS or (name.startswith("cudaMemcpy") and "Async" not in name)


def _keep_syncs(from_events):
    def with_syncs(cls, events):
        events = list(events)
        out = from_events(cls, events)
        cuda = torch.autograd.DeviceType.CUDA
        out.syncs = np.sort(np.asarray([e.start_ns() for e in events
                                        if e.device_type() != cuda and is_sync(e.name())],
                                       np.int64))
        return out

    with_syncs.keeps_syncs = True
    return classmethod(with_syncs)


if not getattr(trace.Trace.from_events, "keeps_syncs", False):
    trace.Trace.from_events = _keep_syncs(trace.Trace.__dict__["from_events"].__func__)


def begin() -> None:
    """Empty the port's tracer and turn it on (no-op without one)."""
    if TRACER is not None:
        TRACER.clear()
        TRACER.enable()


def spans():
    """The port's spans of this run (objects with ``name``, ``start_ns``,
    ``end_ns``, ``parent``, ``dispatch``), or None without any."""
    return TRACER.spans if TRACER is not None and TRACER.spans else None


def in_window(sp, name: str, window: tuple) -> list:
    """The closed spans ``name`` that start inside ``window``, in order."""
    lo, hi = window
    return [s for s in sp if s.name == name and lo <= s.start_ns < hi and s.end_ns >= 0]


def setup_build_s(sp):
    """Host seconds in runner.build, kernels.load and runner.prime before the
    first dispatch opens: the union of their intervals, so that a load inside
    the prime counts once."""
    if not sp:
        return None
    first = next((s.start_ns for s in sp if s.name == "runner.dispatch"), None)
    if first is None:
        return None
    iv = [(s.start_ns, s.end_ns) for s in sp
          if s.name in BUILD and s.start_ns < first and s.end_ns >= 0]
    if not iv:
        return None
    a = np.asarray(iv, np.int64)
    return sum(e - s for s, e in trace.union_ns(a[:, 0], a[:, 1], int(a.min()), first)) * 1e-9


def settle_s(sp):
    """Host seconds in the damped settle (runner.settle) before the first
    dispatch opens, or None where there was none."""
    if not sp:
        return None
    first = next((s.start_ns for s in sp if s.name == "runner.dispatch"), None)
    d = [s.end_ns - s.start_ns for s in sp if s.name == "runner.settle"
         and s.end_ns >= 0 and (first is None or s.start_ns < first)]
    return sum(d) * 1e-9 if d else None


def syncs_per_span(tr, sp, name: str):
    """Runtime synchronisations whose host time lies inside a span ``name``
    of the traced window, over the number of those spans; None where the
    profiler recorded no synchronisation (a trace without CUDA activity)."""
    if tr is None or not sp or getattr(tr, "syncs", None) is None or not tr.syncs.size:
        return None
    inside = in_window(sp, name, tr.window)
    if not inside:
        return None
    s = np.asarray([x.start_ns for x in inside], np.int64)
    e = np.asarray([x.end_ns for x in inside], np.int64)
    i = np.searchsorted(s, tr.syncs, side="right") - 1
    hit = (i >= 0) & (tr.syncs < e[np.clip(i, 0, len(e) - 1)])
    return int(hit.sum()) / len(inside)


def mean_ms(tr, sp, name: str):
    """Mean host wall of the spans ``name`` of the traced window, in ms."""
    if tr is None or not sp:
        return None
    inside = in_window(sp, name, tr.window)
    if not inside:
        return None
    return float(np.mean([x.end_ns - x.start_ns for x in inside])) * 1e-6
