"""The jnp-oracle WCSPH stepper, leapfrog KDK (port of
`pi_sph_fluid_tpu/models/simulation.py:38-173`).

Mirrors the reference main loop (`pi_sph_fluid.c:610-644`):

    kick(DT/2, old accel) -> drift(DT) -> rebuild grid ->
    density -> EOS -> accelerations -> kick(DT/2, new accel)

with the priming pass (`pi_sph_fluid.c:604-607`) computing the step-0
accelerations.  The fluid is kept in grid-sorted order (``ids`` tracks the
original identity); candidates are dense fixed-capacity windows
(ops/neighbors.py) with overflow counted.  This is the verification
reference and the runner's ``backend="reference"``; the production stepper
is models/engine_v3.WindowEngine.  ``make_multi_step`` runs K ticks per call
as a Python loop (the JAX package's lax.scan) and stacks the per-tick stats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SPHConfig
from ..core.eos import tait_pressure
from ..core.kernels import div_scalar
from ..ops.density import density_pass
from ..ops.forces import acceleration_pass
from ..ops.grid import GridContext, build_grid
from ..ops.neighbors import gather_candidates, span_overflow
from ..state import BoundaryState, FluidState

__all__ = ["SimState", "StepStats", "OVERFLOW_CATEGORIES", "prime", "make_step",
           "make_multi_step", "stats", "host_gravity"]


class SimState(NamedTuple):
    fluid: FluidState     # grid-sorted
    ids: torch.Tensor     # (N,) int32, original particle id of each slot
    au: torch.Tensor      # (N,) accelerations from the previous force pass
    av: torch.Tensor


# The order of StepStats.overflow_by (`simulation.py:45-48`): the slab
# decomposition stacks its counts so, the runner's targeted recovery and the
# CLI's summary name them by it.
OVERFLOW_CATEGORIES = ("window", "halo", "mig", "slab")


class StepStats(NamedTuple):
    """Per-tick invariants (`pi_sph_fluid.c:656-675`).

    neighbor_overflow counts window lanes lost to the cap, plus x1e6 for
    every non-finite real row or L-budget overrun: it must read 0.
    overflow_by (the slab decomposition only) splits the capacity losses by
    OVERFLOW_CATEGORIES, so that recovery grows the starved buffer alone;
    neighbor_overflow stays the total and carries the screams.
    stale (sticky modes only) counts real particles that drifted more than
    0.3*H since their group's layout was built."""

    max_rho_error_pct: torch.Tensor
    max_speed: torch.Tensor
    neighbor_overflow: torch.Tensor
    overflow_by: torch.Tensor | None = None
    stale: torch.Tensor | None = None


def host_gravity(g) -> np.ndarray:
    """Gravity as host float32 numpy (a pair or a (K, 2) trace; tensors are
    copied off the device once), so that the steppers pass it as float
    arguments and reading it never waits for the device."""
    if isinstance(g, torch.Tensor):
        g = g.detach().cpu().numpy()
    return np.asarray(g, np.float32)


def _sort_and_neighbors(fluid: FluidState, ids, boundary_grid: GridContext,
                        cfg: SPHConfig):
    grid = build_grid(fluid.x, fluid.y, cfg)
    fluid = fluid.permute(grid.order)
    ids = ids[grid.order.long()]
    cand_ff = gather_candidates(fluid.x, fluid.y, grid, cfg)
    cand_fb = gather_candidates(fluid.x, fluid.y, boundary_grid, cfg)
    overflow = (span_overflow(fluid.x, fluid.y, grid, cfg)
                + span_overflow(fluid.x, fluid.y, boundary_grid, cfg))
    return fluid, ids, cand_ff, cand_fb, overflow


def _forces(fluid: FluidState, boundary: BoundaryState, cand_ff, cand_fb, g,
            cfg: SPHConfig):
    rho = density_pass(fluid, boundary, cand_ff, cand_fb, cfg)
    fluid = fluid._replace(rho=rho, p=tait_pressure(rho, cfg))
    au, av = acceleration_pass(fluid, boundary, cand_ff, cand_fb,
                               float(g[0]), float(g[1]), cfg)
    return fluid, au, av


def prime(fluid: FluidState, boundary: BoundaryState, boundary_grid: GridContext,
          g, cfg: SPHConfig) -> SimState:
    """Step-0 initialisation (`pi_sph_fluid.c:604-607`): sort, density, EOS,
    accelerations; no integration."""
    ids = torch.arange(fluid.n, dtype=torch.int32, device=fluid.x.device)
    fluid, ids, cand_ff, cand_fb, _ = _sort_and_neighbors(fluid, ids, boundary_grid, cfg)
    fluid, au, av = _forces(fluid, boundary, cand_ff, cand_fb, host_gravity(g), cfg)
    return SimState(fluid=fluid, ids=ids, au=au, av=av)


def make_step(cfg: SPHConfig, boundary: BoundaryState, boundary_grid: GridContext,
              damping: float = 1.0):
    """``step(sim, g) -> (sim, StepStats)``, one tick.  ``boundary`` and
    ``boundary_grid`` are static captures; ``damping`` < 1 scales the
    velocities every tick (settling runs)."""
    dt = float(np.float32(cfg.dt))
    half_dt = float(np.float32(0.5) * np.float32(cfg.dt))
    damp = float(np.float32(damping))

    def step(sim: SimState, g) -> tuple[SimState, StepStats]:
        g = host_gravity(g)
        f = sim.fluid
        # kick (old accelerations) + drift (`pi_sph_fluid.c:614-624`)
        u = f.u + half_dt * sim.au
        v = f.v + half_dt * sim.av
        f = f._replace(x=f.x + dt * u, y=f.y + dt * v, u=u, v=v)
        f, ids, cand_ff, cand_fb, overflow = _sort_and_neighbors(f, sim.ids,
                                                                 boundary_grid, cfg)
        f, au, av = _forces(f, boundary, cand_ff, cand_fb, g, cfg)
        # kick (new accelerations) (`pi_sph_fluid.c:637-640`)
        f = f._replace(u=(f.u + half_dt * au) * damp, v=(f.v + half_dt * av) * damp)
        new_sim = SimState(fluid=f, ids=ids, au=au, av=av)
        return new_sim, stats(new_sim, cfg, overflow)

    return step


def make_multi_step(cfg: SPHConfig, boundary: BoundaryState,
                    boundary_grid: GridContext, damping: float = 1.0):
    """``multi_step(sim, g_trace) -> (sim, StepStats[K])`` over a (K, 2)
    gravity trace."""
    step = make_step(cfg, boundary, boundary_grid, damping)

    def multi_step(sim: SimState, g_trace):
        out = []
        for g in host_gravity(g_trace):
            sim, st = step(sim, g)
            out.append(st)
        return sim, StepStats(*(None if vals[0] is None else torch.stack(vals)
                                for vals in zip(*out)))

    return multi_step


def stats(sim: SimState, cfg: SPHConfig, overflow=None) -> StepStats:
    """Per-tick invariants (`pi_sph_fluid.c:656-675`).  Non-finite rows fold
    into the overflow scream (x1e6), as in the JAX package."""
    rho0 = float(np.float32(cfg.rho_0))
    f = sim.fluid
    max_rho_error = torch.max(f.rho - rho0)
    speed2 = f.u * f.u + f.v * f.v
    probe = f.x + speed2 + f.rho                 # NaN/inf propagates
    bad = torch.sum(~torch.isfinite(probe), dtype=torch.int32)
    ov = (torch.zeros((), dtype=torch.int32, device=f.x.device)
          if overflow is None else overflow)
    return StepStats(
        max_rho_error_pct=div_scalar(torch.clamp_min(max_rho_error, 0.0), rho0)[0] * 100.0,
        max_speed=torch.sqrt(torch.max(speed2)),
        neighbor_overflow=ov + torch.clamp_max(bad, 1000) * 1_000_000)
