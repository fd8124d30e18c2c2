"""The traced run: spans around the calls into each layer of the port, and
the reduction of a ``torch.profiler`` trace to what the per-layer metrics
read.

The spans are ``torch.profiler.record_function`` ranges installed on the
port's classes from here, in the traced run only; no file of the port
changes.  Each device operation (kernel, copy, fill) is tied to the host
time of the runtime call that launched it, through the profiler's
correlation ids, and so to the spans open at that time.
"""

from __future__ import annotations

import contextlib
import functools
import re
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["SPANS", "install_spans", "Trace", "union_ns", "idle_gaps"]

# span name -> (module path, class, method) of the port; a span opens
# around every call of the method
SPANS = {
    "runner.run": ("io.host_loop", "SimRunner", "run"),
    "runner.dispatch": ("io.host_loop", "SimRunner", "_dispatch"),
    "runner.rebuild": ("io.host_loop", "SimRunner", "_build"),
    "stepper.relayout": ("models.engine_v3", "WindowEngine", "_relayout"),
    "render.frame": ("render.metaballs_window", "WindowRenderer", "render_from_frame"),
    "stats.drain": ("utils.stats", "StatsReporter", "_drain"),
}
# innermost first: what the host was doing when the device went idle
_NESTING = ["sink.push", "stats.drain", "render.frame", "stepper.relayout",
            "runner.rebuild", "runner.dispatch", "runner.run", "bench.window"]


def _spanned(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def install_spans(port):
    """Wrap each method of SPANS in its span for the duration of the block
    (``port`` is the imported port package); restores the methods after."""
    import importlib

    saved = []
    try:
        for name, (mod, cls, meth) in SPANS.items():
            klass = getattr(importlib.import_module(f"{port.__name__}.{mod}"), cls)
            orig = klass.__dict__[meth]
            saved.append((klass, meth, orig))
            setattr(klass, meth, _spanned(name, orig))
        yield
    finally:
        for klass, meth, orig in reversed(saved):
            setattr(klass, meth, orig)


def union_ns(starts: np.ndarray, ends: np.ndarray, lo: int, hi: int) -> list:
    """The union of intervals [start, end) clipped to [lo, hi), as a sorted
    list of disjoint (start, end)."""
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    order = np.argsort(s, kind="stable")
    out = []
    for a, b in zip(s[order].tolist(), e[order].tolist()):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(busy: list, lo: int, hi: int) -> list:
    """The (start, end) stretches of [lo, hi) that no busy interval covers."""
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def _short(name: str) -> str:
    """A device operation's name without its return type, namespace noise
    and argument list, at most 96 characters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:96] or name[:96]


@dataclass
class Trace:
    """Device operations and host spans of one traced window, in ns on the
    profiler's clock."""

    names: list                     # device operation names
    start: np.ndarray               # device start
    end: np.ndarray                 # device end
    launch: np.ndarray              # host time of the launching call, -1 unknown
    is_kernel: np.ndarray           # False for copies and fills
    spans: dict = field(default_factory=dict)   # name -> (starts, ends) sorted
    window: tuple = (0, 0)
    unlinked: int = 0               # device operations with no launching call

    @classmethod
    def from_events(cls, events) -> "Trace":
        """From the profiler's raw events (``prof.profiler.kineto_results
        .events()``), or any objects with the same accessors."""
        cuda = torch.autograd.DeviceType.CUDA
        host_calls, dev, spans = {}, [], {}
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                # the GPU-timeline copies of the spans are not device work
                if name not in _NESTING:
                    dev.append(e)
                continue
            if name in _NESTING:
                spans.setdefault(name, []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith(("cuda", "cu")):
                host_calls[e.correlation_id()] = e.start_ns()
        names = [e.name() for e in dev]
        start = np.asarray([e.start_ns() for e in dev], np.int64)
        end = start + np.asarray([e.duration_ns() for e in dev], np.int64)
        launch = np.full(len(dev), -1, np.int64)
        for n, e in enumerate(dev):
            for corr in (e.correlation_id(), e.linked_correlation_id()):
                t = host_calls.get(corr)
                if corr and t is not None:
                    launch[n] = t
                    break
        is_kernel = np.asarray([not nm.startswith(("Memcpy", "Memset", "memcpy", "memset"))
                                for nm in names], bool)
        sp = {}
        for name, iv in spans.items():
            a = np.asarray(sorted(iv), np.int64).reshape(-1, 2)
            sp[name] = (a[:, 0], a[:, 1])
        w = sp.get("bench.window")
        window = (int(w[0][0]), int(w[1][0])) if w is not None else (
            int(start.min()) if len(start) else 0, int(end.max()) if len(end) else 0)
        return cls(names=names, start=start, end=end, launch=launch,
                   is_kernel=is_kernel, spans=sp, window=window,
                   unlinked=int((launch < 0).sum()))

    # ---- queries -----------------------------------------------------------
    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def in_window(self) -> np.ndarray:
        """Device operations launched inside the window (by device time
        where the launch is unknown)."""
        t = np.where(self.launch >= 0, self.launch, self.start)
        return (t >= self.window[0]) & (t < self.window[1])

    def under(self, span: str) -> np.ndarray:
        """Device operations launched while a ``span`` was open."""
        if span not in self.spans:
            return np.zeros(len(self.names), bool)
        s, e = self.spans[span]
        i = np.searchsorted(s, self.launch, side="right") - 1
        ok = (i >= 0) & (self.launch >= 0)
        return ok & (self.launch < e[np.clip(i, 0, len(e) - 1)])

    def count(self, span: str) -> int:
        """Spans of this name that start inside the window."""
        if span not in self.spans:
            return 0
        s = self.spans[span][0]
        return int(((s >= self.window[0]) & (s < self.window[1])).sum())

    def span_ns(self, span: str) -> np.ndarray:
        """Host durations of the spans of this name inside the window."""
        if span not in self.spans:
            return np.zeros(0, np.int64)
        s, e = self.spans[span]
        keep = (s >= self.window[0]) & (s < self.window[1])
        return (e - s)[keep]

    def device_ns(self, mask: np.ndarray) -> int:
        """Summed device time of the masked operations."""
        return int((self.end - self.start)[mask].sum())

    def busy(self) -> list:
        """The union of every device operation's interval in the window."""
        return union_ns(self.start, self.end, *self.window)

    def busy_ns(self) -> int:
        return sum(b - a for a, b in self.busy())

    def host_span_at(self, t: int) -> str:
        """The innermost span open at host time ``t``."""
        for name in _NESTING:
            if name in self.spans:
                s, e = self.spans[name]
                i = int(np.searchsorted(s, t, side="right")) - 1
                if i >= 0 and t < e[i]:
                    return name
        return "outside"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing when each gap began; seconds, largest first."""
        inw = self.in_window()
        by_op: dict = {}
        for nm, d in zip((n for n, k in zip(self.names, inw) if k),
                         (self.end - self.start)[inw].tolist()):
            key = _short(nm)
            by_op[key] = by_op.get(key, 0) + d
        gaps: dict = {}
        for a, b in idle_gaps(self.busy(), *self.window):
            key = self.host_span_at(a)
            gaps[key] = gaps.get(key, 0) + (b - a)
        fmt = lambda d: [[k, v * 1e-9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": fmt(by_op), "idle_gaps": fmt(gaps)}
