"""Runtime invariant reporting, the reference's stats block (port of
`pi_sph_fluid_tpu/utils/stats.py:32-158`).

The reference prints every 0.1 sim-seconds (`pi_sph_fluid.c:679-691`):

    sim time: 1.20, ticks/s: 4102, max rho error: 0.3% (worst) 1.2%, ...

with the max-density comparison bug fixed (`pi_sph_fluid.c:658-659`) and
the neighbor-overflow and stale-drift counters this framework adds.

Accumulation is lazy: ``update`` only queues a dispatch's device stats; a
drain reduces every queued dispatch on its device and moves the result to
the host in one ``torch.stack(...).cpu()``, once per report line (or when a
worst-case property is read), never once per field or per dispatch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .tracer import tracer

__all__ = ["StatsReporter"]


def _column(st) -> torch.Tensor:
    """One dispatch's stats as float64 [max rho error %, max speed,
    overflow sum, stale sum, overflow_by sums (4)] on their device (float64
    holds the int sums exactly; no overflow_by reads as zeros)."""
    ov = st.neighbor_overflow.sum(dtype=torch.int64)
    stale = torch.zeros_like(ov) if st.stale is None else st.stale.sum(dtype=torch.int64)
    by = (ov.new_zeros(4) if st.overflow_by is None
          else st.overflow_by.reshape(-1, 4).sum(0, dtype=torch.int64))
    return torch.cat([torch.stack([st.max_rho_error_pct.max().double(),
                                   st.max_speed.max().double(), ov.double(),
                                   stale.double()]), by.double()])


@dataclass
class StatsReporter:
    dt: float
    report_every_sim_s: float = 0.1
    stream: object = None

    t: float = 0.0
    _last_report_t: float = 0.0
    _last_report_wall: float = field(default_factory=time.perf_counter)
    _worst_rho: float = 0.0
    _worst_speed: float = 0.0
    _overflow: int = 0
    _overflow_by: np.ndarray | None = None   # (4,) [window, halo, mig, slab]
    _stale: int = 0            # sticky-layout staleness-guard trips
    _window_rho: float = 0.0
    _window_speed: float = 0.0

    _pending: list = field(default_factory=list)

    @property
    def worst_rho_error_pct(self) -> float:
        self._drain()
        return self._worst_rho

    @property
    def worst_speed(self) -> float:
        self._drain()
        return self._worst_speed

    @property
    def total_overflow(self) -> int:
        self._drain()
        return self._overflow

    @property
    def total_overflow_by(self) -> np.ndarray | None:
        """Capacity losses by OVERFLOW_CATEGORIES [window, halo, mig, slab]
        (np.int64 (4,)), or None when no dispatch reported them (every
        backend but the slab decomposition).  SimRunner's recovery grows
        the starved capacities it names."""
        self._drain()
        return None if self._overflow_by is None else self._overflow_by.copy()

    @property
    def total_stale(self) -> int:
        """Sticky-layout staleness-guard trips (particle-ticks whose drift
        since the group's layout exceeded the 0.3*H margin).  SimRunner
        answers a nonzero count by halving resort_every and replaying."""
        self._drain()
        return self._stale

    def _drain(self):
        """Fold the queued device stats into the host-side aggregates: one
        span, under the number of the last dispatch queued, since the copy
        to the host waits for it."""
        if not self._pending:
            return
        has_by = any(st.overflow_by is not None for st in self._pending)
        with tracer.span("stats.drain", dispatch=tracer.last_dispatch):
            rows = torch.stack([_column(st) for st in self._pending]).cpu().tolist()
        self._pending.clear()
        for rho, speed, ov, stale, *by in rows:
            self._window_rho = max(self._window_rho, rho)
            self._window_speed = max(self._window_speed, speed)
            self._worst_rho = max(self._worst_rho, rho)
            self._worst_speed = max(self._worst_speed, speed)
            self._overflow += int(ov)
            self._stale += int(stale)
            if has_by:
                base = np.zeros(4, np.int64) if self._overflow_by is None else self._overflow_by
                self._overflow_by = base + np.asarray(by, np.int64)

    def snapshot(self) -> tuple:
        """Drain and capture the host-side aggregates (SimRunner's elastic
        recovery rewinds the reporter with the state)."""
        self._drain()
        by = None if self._overflow_by is None else self._overflow_by.copy()
        return (self.t, self._last_report_t, self._worst_rho,
                self._worst_speed, self._overflow, by, self._stale)

    def restore(self, snap: tuple) -> None:
        (self.t, self._last_report_t, self._worst_rho, self._worst_speed,
         self._overflow, self._overflow_by, self._stale) = snap
        self._window_rho = 0.0
        self._window_speed = 0.0
        self._pending.clear()
        self._last_report_wall = time.perf_counter()

    def update(self, n_steps: int, step_stats) -> str | None:
        """Queue one dispatch's StepStats (scalars or (k,) tensors); returns
        the report line when one is due, and waits on the device only then."""
        self._pending.append(step_stats)
        self.t += n_steps * self.dt

        if self.t - self._last_report_t < self.report_every_sim_s:
            return None
        self._drain()
        now = time.perf_counter()
        elapsed = now - self._last_report_wall
        tps = int((self.t - self._last_report_t) / self.dt / max(elapsed, 1e-9))
        line = (
            f"sim time: {self.t:.2f}, ticks/s: {tps}, "
            f"max rho error: {self._window_rho:.3f}% (worst) {self._worst_rho:.3f}%, "
            f"max speed: {self._window_speed:.1f} m/s (worst) {self._worst_speed:.1f} m/s"
        )
        if self._overflow:
            line += f", NEIGHBOR OVERFLOW: {self._overflow}"
        if self._stale:
            line += f", STALE DRIFT: {self._stale}"
        self._last_report_t = self.t
        self._last_report_wall = now
        self._window_rho = 0.0
        self._window_speed = 0.0
        if self.stream is not None:
            print(line, file=self.stream, flush=True)
        return line
