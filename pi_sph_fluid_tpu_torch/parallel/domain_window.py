"""Slab domain decomposition running the window kernels per slab (port of
`pi_sph_fluid_tpu/parallel/domain_window.py:59-437`, the exact mode,
``resort_every=1``).

The design is the JAX package's (`domain_window.py:1-39`):

* slabs are cell-aligned: slab s owns grid columns [s*k, (s+1)*k),
  k = ceil(m / d), so a slab's local grid is a column shift of the global
  one; the local grid is k + 6 columns, the owned k and a 3-cell halo on
  each side.  Ghost strips are 3 cells wide, so ghost densities are
  computable locally and one halo exchange a step suffices;
* a step: kick and drift, migration by cell column, one halo exchange, one
  local relayout, the density and the forces kernel over owned rows and
  ghosts (ghosts are queries too, their results are dropped), owned rows
  packed back;
* ids ride as int32 through packs and exchanges, and as float values in
  column 7 of the packed state (owned >= 0, ghosts -2, pads -1), so
  ownership survives the layout.

A slab is a port ``WindowEngine`` built once, in the constructor, on the
local config with its own boundary slice: the slice sorted by local cell
and padded to the common ``nb_cap`` with psi = 0 rows at -1e6, which no
span reaches (they are past the slab's boundary CSR), so that every slab's
layout sizes equal JAX's.  The step calls its ``_relayout`` and
``_pair_passes``; on CUDA tensors each launches the two kernels once a slab
and a step, or raises.  All slabs run in this process through a ``Comm``
(parallel/comm.py); stats stay on the device.

Not here yet: sticky groups (``resort_every > 1``, ROADMAP Queue 1 item
10c) and the per-slab renderer (10d).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SPHConfig
from ..core.kernels import div_scalar
from ..models.engine_v3 import WindowEngine
from ..models.simulation import host_gravity
from ..ops.grid import GridContext
from ..state import BoundaryState, FluidState
from .comm import Comm
from .domain import (INERT_X, DomainState, _distribute, _exchange, _inert,
                     _np, _round_up, _split, _join, _take_first, gather_by_id,
                     saturating_sum)

__all__ = ["WindowDomain", "GHOST_ID"]

GHOST_ID = -2
_I32 = torch.int32


def _local_cfg(cfg: SPHConfig, local_cols: int) -> SPHConfig:
    """A config whose grid is (n_cell_rows, local_cols): the same cell size
    and height, the width chosen so that the column count comes out exactly
    (`domain_window.py:63-70`)."""
    lc = cfg.replace(width=(local_cols - 0.5) * cfg.cell_length)
    assert lc.n_cell_cols == local_cols, (lc.n_cell_cols, local_cols)
    assert lc.n_cell_rows == cfg.n_cell_rows
    assert np.float32(lc.cell_length) == np.float32(cfg.cell_length)
    return lc


def _gcol(x, inv_cell: float, m: int):
    """Global cell column, JAX's ``clip(int32(x * inv_cell), 0, m - 1)``:
    truncation and clip agree with a clamp to [-1, m] first, which keeps the
    float -> int cast in range (and maps NaN to column 0, as XLA does)."""
    return torch.clamp(torch.clamp(x * inv_cell, -1.0, float(m)).to(_I32), 0, m - 1)


class WindowDomain:
    """Slab domain decomposition running the window-kernel pipeline, all
    slabs in this process through ``comm`` on ``device``."""

    HALO_CELLS = 3

    def __init__(self, cfg: SPHConfig, boundary: BoundaryState,
                 boundary_grid: GridContext, n_global: int, comm: Comm, device,
                 slab_cap: int | None = None, halo_cap: int | None = None,
                 mig_cap: int | None = None, tq: int = 256, qb: int = 16,
                 cap: int = 256, seg_q: int = 2):
        self.cfg = cfg
        self.comm = comm
        self.device = torch.device(device)
        d = self.n_slabs = comm.d
        m = cfg.n_cell_cols
        hc = self.HALO_CELLS
        self.k_cols = -(-m // d)                     # owned columns a slab
        self.local_cols = self.k_cols + 2 * hc
        self.lcfg = _local_cfg(cfg, self.local_cols)
        cell = np.float32(cfg.cell_length)
        self.slab_w_cells = self.k_cols * float(cell)

        # physical area bounds (`domain_window.py:109-117`, domain.py)
        def area_cap(strip_w: float, slack: float = 1.35) -> int:
            return int(strip_w * cfg.height / (cfg.r * cfg.r) * slack) + 1

        self.slab_cap = slab_cap or _round_up(
            min(area_cap(self.slab_w_cells), n_global) + 64, 128)
        self.halo_cap = halo_cap or _round_up(
            min(area_cap(hc * float(cell)), n_global) + 64, 64)
        self.mig_cap = mig_cap or _round_up(
            min(area_cap(cfg.h), n_global) + 64, 64)
        self.n_local = self.slab_cap + 2 * self.halo_cap

        # ---- per-slab static boundary slices, sorted by local cell --------
        # (`domain_window.py:120-160`), each padded to the common nb_cap
        bx, by, bpsi = (_np(f) for f in (boundary.x, boundary.y, boundary.m))
        gcol = np.clip((bx / cell).astype(np.int64), 0, m - 1)
        grow = np.clip((by / cell).astype(np.int64), 0, cfg.n_cell_rows - 1)
        slices = []
        for s in range(d):
            lo = s * self.k_cols - hc
            sel = np.nonzero((gcol >= lo) & (gcol < lo + self.local_cols))[0]
            lcell = grow[sel] * self.local_cols + (gcol[sel] - lo)
            order = np.argsort(lcell, kind="stable")
            slices.append((sel[order], lcell[order]))
        self.nb_cap = _round_up(max(max(len(sel) for sel, _ in slices), 1), 8)
        n_lcells = self.lcfg.n_cells
        self.engines = []
        for s, (sel, lcell) in enumerate(slices):
            shift = np.float32(s * self.k_cols - hc) * cell
            n = len(sel)

            def pad(vals, fill, dtype=np.float32):
                out = np.full(self.nb_cap, fill, dtype)
                out[:n] = vals
                return torch.from_numpy(out)

            zero = pad(np.zeros(n), 0.0)
            b = BoundaryState(x=pad((bx[sel] - shift).astype(np.float32), INERT_X),
                              y=pad(by[sel], INERT_X), u=zero, v=zero,
                              m=pad(bpsi[sel], 0.0),
                              rho=pad(np.full(n, cfg.rho_0), cfg.rho_0))
            csr = np.zeros(n_lcells + 1, np.int32)
            csr[1:] = np.cumsum(np.bincount(lcell, minlength=n_lcells))
            grid = GridContext(order=pad(sel, -1, np.int32),
                               sorted_cells=pad(lcell, n_lcells, np.int32),
                               cell_starts=torch.from_numpy(csr))
            self.engines.append(WindowEngine(self.lcfg, b, grid, self.n_local,
                                             self.device, tq, qb, cap, seg_q))
        self.spec = self.engines[0].spec

    # ------------------------------------------------------------------
    def init(self, fluid: FluidState, au=None, av=None) -> DomainState:
        """Distribute a global FluidState into the slab arrays by cell
        column (`domain_window.py:196-232`).  ``au``/``av`` (id order, as
        ``export`` gives them) carry the leapfrog acceleration term, so a
        checkpoint resumes exactly, also into a domain built with other
        capacities; without them the first half-kick sees zero
        acceleration, as at scene start.  Raises when a slab is over its
        capacity."""
        cell = np.float32(self.cfg.cell_length)
        gcol = np.clip((_np(fluid.x) / cell).astype(np.int64), 0,
                       self.cfg.n_cell_cols - 1)
        dest = np.clip(gcol // self.k_cols, 0, self.n_slabs - 1)
        return _distribute(fluid, dest, self.n_slabs, self.slab_cap,
                           self.device, au, av)

    # ------------------------------------------------------------------
    def _shift(self, s: int) -> float:
        """Slab s's local frame: x_local = x - shift."""
        cell = np.float32(self.cfg.cell_length)
        return float(np.float32(s * self.k_cols - self.HALO_CELLS) * cell)

    def _build_packed(self, fields, ids_f, shift: float):
        """Slab and ghost fields -> (n_layout, 8) packed state in the slab's
        frame (`domain_window.py:242-252`): x shifted only where m > 0; the
        rows past the particle capacity are zero pads with id -1 (m = 0
        sorts them out with the inert key)."""
        x = torch.where(fields[4] > 0, fields[0] - shift, fields[0])
        packed = torch.zeros((self.spec.n_layout, 8), dtype=torch.float32,
                             device=self.device)
        packed[:self.n_local] = torch.stack([x] + list(fields[1:7]) + [ids_f], 1)
        packed[self.n_local:, 7] = -1.0
        return packed

    def _front(self, state: DomainState):
        """Kick, drift, migration, pack, halo exchange: per slab (packed
        state in the slab's frame, overflows [halo, mig, slab])."""
        cfg, comm, d, k = self.cfg, self.comm, self.n_slabs, self.k_cols
        hc, m = self.HALO_CELLS, cfg.n_cell_cols
        dt = float(np.float32(cfg.dt))
        half = float(np.float32(0.5) * np.float32(cfg.dt))
        inv_cell = float(np.float32(1.0) / np.float32(cfg.cell_length))

        fluids, idss, go_l, go_r, stays = [], [], [], [], []
        for s, (f, ids, au, av) in enumerate(_split(state, d)):
            valid = f.m > 0
            # kick + drift in global coordinates (`pi_sph_fluid.c:614-624`)
            u = f.u + half * au
            v = f.v + half * av
            f = f._replace(x=torch.where(valid, f.x + dt * u, f.x),
                           y=torch.where(valid, f.y + dt * v, f.y),
                           u=torch.where(valid, u, 0.0),
                           v=torch.where(valid, v, 0.0))
            # migration: cell-column crossers move to the neighbour slab
            dest = torch.clamp(_gcol(f.x, inv_cell, m) // k, 0, d - 1)
            go_l.append(valid & (dest < s))
            go_r.append(valid & (dest > s))
            stays.append(valid & ~(go_l[-1] | go_r[-1]))
            fluids.append(f)
            idss.append(ids)
        from_l, from_r, ov_mig = _exchange(
            comm, go_l, go_r, [list(f) + [i] for f, i in zip(fluids, idss)],
            self.mig_cap)

        slabs, strip_l, strip_r, ov_cap = [], [], [], []
        for s in range(d):
            f = _inert(fluids[s], stays[s])
            ids = torch.where(stays[s], idss[s], -1)
            merged = [torch.cat([a, b, c]) for a, b, c in
                      zip(list(f) + [ids], from_l[s], from_r[s])]
            packed, valid, ov = _take_first(merged[4] > 0, merged, self.slab_cap)
            f = _inert(FluidState(*packed[:7]), valid)
            slabs.append((f, torch.where(valid, packed[7], -1), valid))
            ov_cap.append(ov)
            # the 3-cell strips at either edge are the neighbours' ghosts
            gcol = _gcol(f.x, inv_cell, m)
            strip_l.append(valid & (gcol < s * k + hc))
            strip_r.append(valid & (gcol >= (s + 1) * k - hc))

        # ---- one halo exchange ---------------------------------------------
        from_l, from_r, ov_h = _exchange(comm, strip_l, strip_r,
                                         [list(f) for f, _, _ in slabs],
                                         self.halo_cap)
        out = []
        for s, (f, ids, valid) in enumerate(slabs):
            cat = [torch.cat([a, b, c]) for a, b, c in zip(f, from_l[s], from_r[s])]
            ids_f = torch.cat([
                torch.where(valid, ids.to(torch.float32), -1.0),
                torch.full((2 * self.halo_cap,), float(GHOST_ID),
                           dtype=torch.float32, device=self.device)])
            out.append((self._build_packed(cat, ids_f, self._shift(s)),
                        (ov_h[s], ov_mig[s], ov_cap[s])))
        return out

    def layouts(self, state: DomainState) -> list:
        """What the next step's kernels read, per slab: (engine, packed
        state after the relayout, its TripleCtx)."""
        return [(eng, *eng._relayout(packed)[:2])
                for eng, (packed, _) in zip(self.engines, self._front(state))]

    # ------------------------------------------------------------------
    def make_step(self, damping: float = 1.0):
        """``step(DomainState, g) -> (DomainState, stats)`` (`domain_window.py
        :254-398`).  ``stats`` is JAX's dict of device tensors:
        ``max_rho_error_pct``, ``max_speed``, ``overflow`` (every dropped
        lane, row or ghost, plus x1e6 a non-finite owned row, at most 1000
        a slab), ``n_valid`` and ``overflow_by``, the drops by capacity
        [window, halo, mig, slab].  Nothing in a step reads the device from
        the host.  ``damping`` < 1 scales the velocities each tick (the
        settle pre-roll)."""
        cfg, comm = self.cfg, self.comm
        half = float(np.float32(0.5) * np.float32(cfg.dt))
        damp = float(damping)
        rho0 = float(np.float32(cfg.rho_0))

        def step(state: DomainState, g):
            g = host_gravity(g)
            fluids, idss, aus, avs = [], [], [], []
            ov_all, ov_by, rho_err, speed2, n_valid = [], [], [], [], []
            for s, (eng, (packed, (ov_h, ov_mig, ov_cap))) in enumerate(
                    zip(self.engines, self._front(state))):
                pk, ctx, ov_w = eng._relayout(packed)
                # ghost densities are complete for every candidate an owned
                # query reaches (module docstring), so one exchange serves
                # both kernels; the forces kernel returns the finished state
                # (trailing half-kick and damping fused): cols 2-3 are the
                # new u, v and cols 5-6 the fresh rho, p
                pk, au, av = eng._pair_passes(pk, ctx, g, half, damp)
                owner = (pk[:, 7] >= 0.0) & (pk[:, 4] > 0)
                cols, valid, _ = _take_first(
                    owner, [pk[:, j] for j in range(8)] + [au, av], self.slab_cap)
                x = torch.where(valid, cols[0] + self._shift(s), cols[0])
                f = _inert(FluidState(x, *cols[1:7]), valid)
                fluids.append(f)
                idss.append(torch.where(valid, cols[7].to(_I32), -1))
                aus.append(cols[8])
                avs.append(cols[9])

                sp2 = f.u * f.u + f.v * f.v
                # JAX's form (`domain_window.py:349`); the single engine
                # takes max(where(m > 0, rho, 0) - rho0), the same number
                # over the same particles (0 - rho0 is exact)
                rho_err.append(torch.max(torch.where(valid, f.rho - rho0, -rho0)))
                speed2.append(torch.max(torch.where(valid, sp2, 0.0)))
                # non-finite owned rows scream x1e6 (the TPU's max drops
                # NaN, so JAX needs this to see a dead slab)
                probe = f.x + sp2 + f.rho
                bad = torch.sum(valid & ~torch.isfinite(probe), dtype=_I32)
                by = torch.stack([ov_w.to(_I32), ov_h, ov_mig, ov_cap])
                ov_by.append(by)
                # summed in int64: a slab's window count and its scream can
                # approach the int32 maximum together
                ov_all.append(by.to(torch.int64).sum()
                              + torch.clamp_max(bad, 1000).to(torch.int64) * 1_000_000)
                n_valid.append(torch.sum(valid, dtype=_I32))
            err = comm.all_max(rho_err)
            stats = {
                "max_rho_error_pct":
                    div_scalar(torch.clamp_min(err, 0.0), rho0)[0] * 100.0,
                "max_speed": torch.sqrt(comm.all_max(speed2)),
                # saturated, not wrapped (ROADMAP Queue 3): JAX's int32 psum
                # of :355/:365 goes negative from three screaming slabs on
                "overflow": saturating_sum(comm, ov_all),
                "n_valid": comm.all_sum(n_valid),
                "overflow_by": saturating_sum(comm, ov_by),
            }
            return _join(fluids, idss, aus, avs), stats

        return step

    def make_multi_step(self, resort_every: int = 1, damping: float = 1.0):
        """``multi(state, g_trace) -> (state, stats)`` over a (K, 2) gravity
        trace, each stat stacked to (K,) and ``overflow_by`` to (K, 4)."""
        if resort_every > 1:
            raise NotImplementedError(
                "sticky groups (resort_every > 1) of the slab decomposition are "
                "not ported yet: ROADMAP Queue 1 item 10c")
        step = self.make_step(damping)

        def multi(state: DomainState, g_trace):
            out = []
            for g in host_gravity(g_trace):
                state, st = step(state, g)
                out.append(st)
            return state, {key: torch.stack([st[key] for st in out])
                           for key in out[0]}

        return multi

    # ------------------------------------------------------------------
    def gather(self, state: DomainState) -> FluidState:
        """The global fluid state in original id order."""
        return gather_by_id(state)[0]

    def export(self, state: DomainState):
        """(fluid, au, av) in original id order: a lossless checkpoint with
        the leapfrog acceleration carry; ``init(fluid, au, av)`` of this
        domain or of one with other capacities resumes it exactly."""
        return gather_by_id(state, (state.au, state.av))
