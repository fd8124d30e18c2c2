"""The port's tracer: spans at its layer boundaries and named counters, kept
in memory.

Spans are off until ``tracer.enable()``.  Off, ``tracer.span(name)``
returns one shared no-op context, so an untraced run pays one attribute
check a boundary.  On, each span is one record of ``tracer.spans``, in the
order the spans opened:

* ``name``, ``start_ns``, ``end_ns`` (-1 while the span is open);
* ``parent``: the index of the innermost span open when it opened, or -1;
* ``dispatch``: the sequence number of the runner dispatch whose work the
  span is (``next_dispatch``), given where the span opens or inherited from
  its parent; -1 for set-up;
* ``attrs``: the keywords given where it opened.

Times are ``time.perf_counter_ns()`` moved onto the ``torch.profiler``
timeline (Unix-epoch ns, where the profiler stamps its host events and the
device activity it converts) by one offset taken at ``enable()``.  So a
profiler trace of the same process lines up with the spans, and the tracer
never calls the profiler: a span is no profiler event.  Spans are opened
and closed on one thread, the runner's.

Counters (``tracer.count``, ``tracer.counters``) are always on: the kernel
wrappers count their launches here (``kernel.density.launches``,
``kernel.forces.launches``, ``kernel.field.launches``, and the probes'
``probe.window_copy.launches``, ``probe.span_density.launches``), one a
kernel launch.  ``kernel.relayout.launches`` is the exception: it counts
relayouts that went down the relayout kernels (ops/window/relayout.py),
one a relayout, for all of that relayout's launches (its kernels and the
sort's).  ``runner.ticks_reverted`` counts the ticks the runner's reverts
threw away (io/host_loop.py): each revert adds the ticks run since its
checkpoint, replays included, and gives the same number as the ``ticks``
attribute of its ``runner.recover`` span; ``SimRunner.run`` sets it up at
0.

``tracer.to_chrome(path)`` writes the spans as one Chrome trace-event JSON
file (Perfetto, chrome://tracing); ``cli.py run --trace-out F.json`` does
so for a run.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import time
from dataclasses import dataclass

__all__ = ["Span", "Tracer", "tracer"]


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int
    parent: int
    dispatch: int
    attrs: dict


class _Off:
    """The context every span returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A span while tracing is on: its record opens on entry, closes on exit."""

    __slots__ = ("_tracer", "_name", "_dispatch", "_attrs", "_index")

    def __init__(self, tracer, name, dispatch, attrs):
        self._tracer, self._name, self._dispatch, self._attrs = tracer, name, dispatch, attrs

    def __enter__(self):
        t = self._tracer
        parent = t._open[-1] if t._open else -1
        dispatch = self._dispatch
        if dispatch is None:
            dispatch = t.spans[parent].dispatch if parent >= 0 else -1
        self._index = len(t.spans)
        t.spans.append(Span(self._name, time.perf_counter_ns() + t.offset_ns, -1,
                            parent, dispatch, self._attrs))
        t._open.append(self._index)
        return t.spans[self._index]

    def __exit__(self, *exc):
        t = self._tracer
        t.spans[self._index].end_ns = time.perf_counter_ns() + t.offset_ns
        t._open.pop()
        return False


class Tracer:
    """Spans (off until ``enable``) and counters (always on) of one process."""

    def __init__(self):
        self.on = False
        self.offset_ns = 0
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.last_dispatch = -1
        self._open: list[int] = []

    def enable(self) -> None:
        """Record spans from now on; the first call fixes the offset onto the
        profiler's timeline."""
        if not self.on:
            self.offset_ns = time.time_ns() - time.perf_counter_ns()
            self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str, dispatch: int | None = None, **attrs):
        """A context that records one span while tracing is on."""
        if not self.on:
            return _OFF
        return _On(self, name, dispatch, attrs)

    def traced(self, name: str):
        """A decorator: every call of the function is one span ``name``."""
        def wrap(fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                with self.span(name):
                    return fn(*args, **kwargs)

            return call

        return wrap

    def next_dispatch(self) -> int:
        """The sequence number of a new runner dispatch."""
        self.last_dispatch += 1
        return self.last_dispatch

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> dict:
        """Copies of the spans (in opening order) and of the counters."""
        return {"spans": [copy.copy(s) for s in self.spans],
                "counters": dict(self.counters)}

    def clear(self) -> None:
        """Forget every span, counter and dispatch number (tracing stays as
        it is)."""
        self.spans.clear()
        self.counters.clear()
        self._open.clear()
        self.last_dispatch = -1

    def to_chrome(self, path) -> None:
        """The closed spans as complete events ("ph": "X", microseconds on
        the profiler's timeline) of one Chrome trace-event JSON file, each
        with its parent, dispatch and attributes as ``args``; the counters
        under ``otherData``."""
        pid = os.getpid()
        events = [{"name": s.name, "ph": "X", "ts": s.start_ns / 1e3,
                   "dur": (s.end_ns - s.start_ns) / 1e3, "pid": pid, "tid": 0,
                   "args": {"index": i, "parent": s.parent, "dispatch": s.dispatch,
                            **{k: v if isinstance(v, (int, float, str, bool, type(None)))
                               else str(v) for k, v in s.attrs.items()}}}
                  for i, s in enumerate(self.spans) if s.end_ns >= 0]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"counters": dict(self.counters)}}, f)


tracer = Tracer()
