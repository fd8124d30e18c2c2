"""Window-kernel simulation engine (port of
`pi_sph_fluid_tpu/models/engine_v3.py:59-616`).

One tick is the reference's leapfrog (`pi_sph_fluid.c:614-644`):

    kick-drift -> relayout (sort + row-triple frame + block windows and
    the per-block span table) -> density kernel (+ Tait EOS)
    -> forces kernel (+ trailing half-kick) -> on-device stats

Neither kernel is fed by a gather: each block reads its candidates through
its spans (ops/window/triple.py::block_spans), the density kernel from the
packed state and the static boundary rows [x, y, psi, 0], the forces
kernel from the density kernel's geo8 output and the static boundary rows
[x, y, 0, 0, psi, 0, 0, 1].  Under a sticky layout the spans are the
relayout's and the rows are the tick's.

State layout: (n_layout, 8) float32 [x, y, u, v, m, rho, p, id], where the
particle id travels as a float *value* in column 7 (exact below 2^24), so
it relayouts with the row.  Pads carry m = 0, x = y = -1e6, id = -1.

``make_multi_step(resort_every=k)`` reuses one relayout for groups of k
ticks (sticky layout) under the 0.3*H drift guard (``StepStats.stale``).
JAX's scans are Python loops here; stats stay on the device until the
caller reads them, so a run of ticks never waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SPHConfig
from ..core.kernels import div_scalar
from ..ops.grid import GridContext
from ..ops.window.relayout import relayout
from ..ops.window.triple import (INERT_X, Frame, TripleCtx, TripleSpec,
                                 start_grid, triple_spec)
from ..ops.window.window_kernels import density_window, forces_window
from ..state import BoundaryState, FluidState
from ..utils.tracer import tracer
from .simulation import StepStats, host_gravity

__all__ = ["WindowEngine", "TripleSpec", "PackedSim"]

_INERT_ROW = [INERT_X, INERT_X, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0]
_I32 = torch.int32


class PackedSim(NamedTuple):
    """Simulation state in packed layout space (`engine_v3.py:59-72`)."""

    packed: torch.Tensor   # (n_layout, 8): x, y, u, v, m, rho, p, id
    ids: torch.Tensor      # (n_layout,) int32, -1 on pad slots
    au: torch.Tensor       # (n_layout,)
    av: torch.Tensor

    @property
    def fluid(self) -> FluidState:
        p = self.packed
        return FluidState(x=p[:, 0], y=p[:, 1], u=p[:, 2], v=p[:, 3],
                          m=p[:, 4], rho=p[:, 5], p=p[:, 6])


class WindowEngine:
    """Owns the static scene (boundary, capacities) and builds prime / step /
    multi_step for a fixed fluid particle count (`engine_v3.py:75-122`)."""

    def __init__(self, cfg: SPHConfig, boundary: BoundaryState,
                 boundary_grid: GridContext, n_real: int, device,
                 tq: int = 256, qb: int = 16, cap: int = 256, seg_q: int = 2):
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_real = int(n_real)
        if self.n_real >= (1 << 24):
            raise ValueError("float-valued ids are exact only below 2^24")
        nb = int(boundary.x.shape[0])
        self.spec = triple_spec(cfg, self.n_real, nb, tq, qb, cap, seg_q)
        dev = self.device
        self.boundary = BoundaryState(*(f.to(dev) for f in boundary))
        self.b_cell_starts = boundary_grid.cell_starts.to(dev, _I32)
        self._b_grid = start_grid(cfg, self.b_cell_starts)
        b = self.boundary
        zb = torch.zeros_like(b.x)
        # static boundary candidate rows (`engine_v3.py:102-118`): force
        # candidates [x, y, 0, 0, psi, cp=0, re=0, a=1] (fluid-only pressure
        # and viscosity denominator, `pi_sph_fluid.c:350,362`) and density
        # candidates [x, y, psi, 0], in the boundary's cell-sorted order
        self._b_geo_f = torch.stack([b.x, b.y, zb, zb, b.m, zb, zb, zb + 1.0], 1)
        self._b_geo_d = torch.stack([b.x, b.y, b.m, zb], 1)
        self._inert_row = torch.tensor([_INERT_ROW], dtype=torch.float32,
                                       device=dev)
        self.dt = float(np.float32(cfg.dt))
        self.half_dt = float(np.float32(0.5) * np.float32(cfg.dt))

    @property
    def n_layout(self) -> int:
        return self.spec.n_layout

    # ------------------------------------------------------------------
    def _relayout(self, packed: torch.Tensor):
        """Sort into the qb-quantised row layout and build the frame
        (`engine_v3.py:130-171`).  Returns (packed_new, ctx, overflow)."""
        return self._relayout_order(packed)[:3]

    @tracer.traced("stepper.relayout")
    def _relayout_order(self, packed: torch.Tensor):
        """``_relayout`` that also returns the sort's ``order``: layout slot
        j holds input row ``order[ctx.layout_src[j]]`` where
        ``layout_src[j] < n_layout`` (else the inert row).  The slab
        decomposition's sticky group maps its halo rows to slots with it."""
        return relayout(self.spec, self.cfg, packed, self.b_cell_starts,
                        self._b_grid, self._inert_row)

    def _pair_acc(self, packed, ctx: TripleCtx, g,
                  half_dt: float = 0.0, damp: float = 1.0):
        """density -> EOS -> forces -> trailing half-kick over one frame
        (`engine_v3.py:221-261`).  Returns (pk_next, acc (n_layout, 2)); the
        defaults leave u, v unchanged, which is the priming pass."""
        cfg, spec = self.cfg, self.spec
        geo8, rp = density_window(packed, self._b_geo_d, ctx.spans, cfg, spec)
        return forces_window(packed, geo8, rp, self._b_geo_f, ctx.spans,
                             g, cfg, spec, half_dt, damp)

    def _pair_passes(self, packed, ctx: TripleCtx, g,
                     half_dt: float = 0.0, damp: float = 1.0):
        """``_pair_acc`` with the accelerations as (au, av)."""
        pk_next, acc = self._pair_acc(packed, ctx, g, half_dt, damp)
        return pk_next, acc[:, 0], acc[:, 1]

    # ------------------------------------------------------------------
    def _initial_packed(self, fluid: FluidState) -> torch.Tensor:
        n = fluid.n
        if n > self.spec.n_layout:
            raise ValueError("scene larger than layout capacity")
        packed = self._inert_row.repeat(self.spec.n_layout, 1)
        for j, f in enumerate(fluid):
            packed[:n, j] = f.to(self.device, torch.float32)
        packed[:n, 7] = torch.arange(n, dtype=torch.float32, device=self.device)
        return packed

    @staticmethod
    def _sim(pk, au, av) -> PackedSim:
        return PackedSim(packed=pk, ids=pk[:, 7].to(_I32), au=au, av=av)

    def prime(self, fluid: FluidState, g) -> PackedSim:
        """Step-0 pass (`pi_sph_fluid.c:604-607`) into layout space."""
        pk, ctx, _ = self._relayout(self._initial_packed(fluid))
        pk, au, av = self._pair_passes(pk, ctx, host_gravity(g))
        return self._sim(pk, au, av)

    def _kick_drift(self, sim: PackedSim) -> torch.Tensor:
        """Leading half-kick with the old accelerations, then drift
        (`engine_v3.py:330-337`)."""
        pk = sim.packed.clone()
        pk[:, 2] += self.half_dt * sim.au
        pk[:, 3] += self.half_dt * sim.av
        pk[:, 0] += self.dt * pk[:, 2]
        pk[:, 1] += self.dt * pk[:, 3]
        return pk

    # ------------------------------------------------------------------
    def _tick(self, sim: PackedSim, g, damp: float):
        """One tick; also returns the relayout's context."""
        pk, ctx, overflow = self._relayout(self._kick_drift(sim))
        pk, au, av = self._pair_passes(pk, ctx, host_gravity(g),
                                       self.half_dt, damp)
        sim = self._sim(pk, au, av)
        return sim, self.stats(sim, overflow), ctx

    def make_step(self, damping: float = 1.0):
        """One tick (kick-drift-forces-kick, `pi_sph_fluid.c:614-644`):
        ``step(sim, g) -> (sim, StepStats)``."""
        damp = float(damping)

        def step(sim: PackedSim, g):
            return self._tick(sim, g, damp)[:2]

        return step

    def make_multi_step(self, damping: float = 1.0, resort_every: int = 1,
                        return_frame: bool = False):
        """``multi_step(sim, g_trace) -> (sim, StepStats[K])`` over a (K, 2)
        gravity trace (`engine_v3.py:343-483`).

        ``resort_every`` > 1 reuses one relayout for each group of ticks
        (sticky layout).  The drift guard counts, on every carried tick, the
        real particles displaced by more than 0.3*H since the group's layout
        (``stale``).  Stats are sampled: the fresh tick reports its own, the
        carried ticks report zeros except the last, which reports the group
        maxima of per-particle running rho and speed^2 maxima.

        ``return_frame=True`` also returns the last relayout's ``Frame``
        (its start grid and T) for render/metaballs_window.WindowRenderer
        .render_from_frame: ``(sim, stats, frame)``.  The renderer reads the
        returned state's rows through the frame's spans, as the physics
        does; they are ``resort_every - 1`` ticks stale against it, the
        fringe bound the physics runs under (`engine_v3.py:352-357`)."""
        damp = float(damping)

        def finish(sim, stats, ctx):
            out = (sim, _stack(stats))
            return out + (Frame(ctx.start_grid, ctx.T),) if return_frame else out

        if resort_every <= 1:
            def multi_step(sim: PackedSim, g_trace):
                stats = []
                for g in host_gravity(g_trace):
                    sim, st, ctx = self._tick(sim, g, damp)
                    stats.append(st)
                return finish(sim, stats, ctx)

            return multi_step

        k = int(resort_every)
        margin2 = float(np.float32((0.3 * self.cfg.h) ** 2))
        zero = torch.zeros((), dtype=_I32, device=self.device)

        def group(sim: PackedSim, g_group):
            pk, ctx, overflow = self._relayout(self._kick_drift(sim))
            x0, y0, live = pk[:, 0], pk[:, 1], pk[:, 4] > 0
            pk, au, av = self._pair_passes(pk, ctx, g_group[0],
                                           self.half_dt, damp)
            sim = self._sim(pk, au, av)
            stats = [self.stats(sim, overflow, stale=zero)]
            rho_hi = torch.where(live, pk[:, 5], torch.zeros_like(pk[:, 5]))
            sp2_hi = pk[:, 2] * pk[:, 2] + pk[:, 3] * pk[:, 3]
            stales = []
            for g in g_group[1:]:
                pk = self._kick_drift(sim)
                dx = pk[:, 0] - x0
                dy = pk[:, 1] - y0
                stales.append(torch.sum(live & (dx * dx + dy * dy > margin2),
                                        dtype=_I32))
                pk, au, av = self._pair_passes(pk, ctx, g, self.half_dt, damp)
                rho_hi = torch.maximum(rho_hi, torch.where(
                    live, pk[:, 5], torch.zeros_like(pk[:, 5])))
                sp2_hi = torch.maximum(sp2_hi, pk[:, 2] * pk[:, 2] + pk[:, 3] * pk[:, 3])
                sim = self._sim(pk, au, av)
            last = self.stats(sim, zero, stale=stales[-1], rho_hi=rho_hi,
                              sp2_hi=sp2_hi)
            z = torch.zeros((), dtype=torch.float32, device=self.device)
            for s in stales[:-1]:
                stats.append(StepStats(max_rho_error_pct=z, max_speed=z,
                                       neighbor_overflow=zero, stale=s))
            stats.append(last)
            return sim, stats, ctx

        def multi_step(sim: PackedSim, g_trace):
            g_trace = host_gravity(g_trace)
            n = g_trace.shape[0]
            if n % k:
                raise ValueError(f"trace length {n} not a multiple of "
                                 f"resort_every={k}")
            stats = []
            for i in range(0, n, k):
                sim, st, ctx = group(sim, g_trace[i:i + k])
                stats += st
            return finish(sim, stats, ctx)

        return multi_step

    # ------------------------------------------------------------------
    def stats(self, sim: PackedSim, overflow=None, stale=None,
              rho_hi=None, sp2_hi=None) -> StepStats:
        """Per-tick invariants (`engine_v3.py:578-607`).  Non-finite real
        rows fold into the overflow scream (x1e6), as in the JAX package,
        so ``StepStats`` means the same in both.  ``rho_hi`` / ``sp2_hi``
        are the sticky group's per-particle running maxima."""
        rho0 = float(np.float32(self.cfg.rho_0))
        pk = sim.packed
        m, rho = pk[:, 4], pk[:, 5]
        rho_m = torch.where(m > 0, rho, torch.zeros_like(rho)) if rho_hi is None else rho_hi
        max_rho_error = torch.max(rho_m - rho0)
        speed2 = pk[:, 2] * pk[:, 2] + pk[:, 3] * pk[:, 3]
        probe = pk[:, 0] + speed2 + rho                      # NaN/inf propagates
        bad = torch.sum((m > 0) & ~torch.isfinite(probe), dtype=_I32)
        if sp2_hi is not None:
            speed2 = sp2_hi
        ov = torch.zeros((), dtype=_I32, device=pk.device) if overflow is None else overflow
        return StepStats(
            max_rho_error_pct=div_scalar(torch.clamp_min(max_rho_error, 0.0), rho0)[0] * 100.0,
            max_speed=torch.sqrt(torch.max(speed2)),
            neighbor_overflow=ov + torch.clamp_max(bad, 1000) * 1_000_000,
            stale=stale)

    # ------------------------------------------------------------------
    def unpad(self, sim: PackedSim) -> FluidState:
        """Real particles in original id order."""
        ids = sim.ids
        sel = torch.nonzero(ids >= 0).reshape(-1)
        inv = sel[torch.argsort(ids[sel])]
        pk = sim.packed[inv]
        return FluidState(*(pk[:, j] for j in range(7)))


def _stack(stats: list) -> StepStats:
    """Per-tick StepStats -> one StepStats of (K,) tensors."""
    return StepStats(*(None if vals[0] is None else torch.stack(vals)
                       for vals in zip(*stats)))
