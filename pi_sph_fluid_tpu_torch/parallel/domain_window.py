"""Slab domain decomposition running the window kernels per slab (port of
`pi_sph_fluid_tpu/parallel/domain_window.py:59-881`: the exact mode, the
sticky groups and the per-slab renderer).

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
layout sizes equal JAX's.  The step calls its relayout and pair passes; on
CUDA tensors each launches the two kernels once a slab and a tick, or
raises.  A process runs the slabs of ``comm.slabs`` through a ``Comm``
(parallel/comm.py): all of them under ``LocalComm``, its share under
``DistComm``, each step the same collective calls in the same order in
every process; stats stay on the device, reduced across every slab.

``make_multi_step(resort_every=k)`` runs sticky groups of k ticks: the
first is a full step, the other k - 1 stay in the slab's layout and
exchange only the halo members' rows.  ``make_render`` draws each slab's
own pixel columns with one field kernel launch a slab a frame.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..config import SPHConfig
from ..core.kernels import div_scalar
from ..models.engine_v3 import WindowEngine
from ..models.scene import pixel_centers
from ..models.simulation import host_gravity
from ..ops.grid import GridContext, cell_ids, csr_starts
from ..ops.window.triple import span_index, start_grid, triple_spec
from ..render.metaballs import pack_framebuffer
from ..render.metaballs_window import (INERT_PX, field_scale_of, field_window,
                                       pixel_layout, pixel_window_cap)
from ..state import BoundaryState, FluidState
from .comm import Comm
from .domain import (INERT_X, DomainState, _distribute, _exchange, _first,
                     _inert, _np, _round_up, _split, _join, _take_first,
                     gather_by_id, saturating_sum, whole_state)

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


def _running_max(rho_hi, sp2_hi, pk, live):
    """A sticky group's per-row running maxima of rho and u^2 + v^2 over
    the rows live at its layout (`domain_window.py:656-658`).  Both are
    masked by ``live``; JAX masks rho alone, so a pad or dead row that
    carried a speed would raise its group maximum."""
    zero = torch.zeros((), dtype=pk.dtype, device=pk.device)
    sp2 = pk[:, 2] * pk[:, 2] + pk[:, 3] * pk[:, 3]
    return (torch.maximum(rho_hi, torch.where(live, pk[:, 5], zero)),
            torch.maximum(sp2_hi, torch.where(live, sp2, zero)))


class WindowDomain:
    """Slab domain decomposition running the window-kernel pipeline, the
    slabs of ``comm.slabs`` in this process through ``comm`` on ``device``
    (a ``DomainState`` holds those slabs' arrays)."""

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
        # nb_cap is a maximum over every slab, so every process computes
        # every slab's slice and builds engines for its own slabs only
        self.nb_cap = _round_up(max(max(len(sel) for sel, _ in slices), 1), 8)
        n_lcells = self.lcfg.n_cells
        self.engines = []
        for s in comm.slabs:
            sel, lcell = slices[s]
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
        """Distribute a global FluidState (the same on every process) into
        the arrays of this process's slabs by cell column
        (`domain_window.py:196-232`).  ``au``/``av`` (id order, as
        ``export`` gives them) carry the leapfrog acceleration term, so a
        checkpoint resumes exactly, also into a domain built with other
        capacities; without them the first half-kick sees zero
        acceleration, as at scene start.  Raises, on every process, when
        any slab is over its capacity."""
        cell = np.float32(self.cfg.cell_length)
        gcol = np.clip((_np(fluid.x) / cell).astype(np.int64), 0,
                       self.cfg.n_cell_cols - 1)
        dest = np.clip(gcol // self.k_cols, 0, self.n_slabs - 1)
        return _distribute(fluid, dest, self.comm.slabs, self.slab_cap,
                           self.device, au, av)

    # ------------------------------------------------------------------
    def _shift(self, s: int) -> float:
        """Slab s's local frame: x_local = x - shift."""
        cell = np.float32(self.cfg.cell_length)
        return float(np.float32(s * self.k_cols - self.HALO_CELLS) * cell)

    def _strips(self, s: int, x, valid):
        """Slab s's rows in its left and right 3-cell edge strips: the
        neighbours' ghosts (`domain_window.py:306-319`)."""
        inv_cell = float(np.float32(1.0) / np.float32(self.cfg.cell_length))
        gcol = _gcol(x, inv_cell, self.cfg.n_cell_cols)
        k, hc = self.k_cols, self.HALO_CELLS
        return valid & (gcol < s * k + hc), valid & (gcol >= (s + 1) * k - hc)

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
        state in the slab's frame, overflows [halo, mig, slab], the edge
        strips whose rows went out as ghosts)."""
        cfg, comm, d, k = self.cfg, self.comm, self.n_slabs, self.k_cols
        local = comm.slabs
        m = cfg.n_cell_cols
        dt = float(np.float32(cfg.dt))
        half = float(np.float32(0.5) * np.float32(cfg.dt))
        inv_cell = float(np.float32(1.0) / np.float32(cfg.cell_length))

        fluids, idss, go_l, go_r, stays = [], [], [], [], []
        for s, (f, ids, au, av) in zip(local, _split(state, len(local))):
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

        slabs, strips, ov_cap = [], [], []
        for j, s in enumerate(local):
            f = _inert(fluids[j], stays[j])
            ids = torch.where(stays[j], idss[j], -1)
            merged = [torch.cat([a, b, c]) for a, b, c in
                      zip(list(f) + [ids], from_l[j], from_r[j])]
            packed, valid, ov = _take_first(merged[4] > 0, merged, self.slab_cap)
            f = _inert(FluidState(*packed[:7]), valid)
            slabs.append((f, torch.where(valid, packed[7], -1), valid))
            ov_cap.append(ov)
            strips.append(self._strips(s, f.x, valid))

        # ---- one halo exchange ---------------------------------------------
        from_l, from_r, ov_h = _exchange(comm, [st[0] for st in strips],
                                         [st[1] for st in strips],
                                         [list(f) for f, _, _ in slabs],
                                         self.halo_cap)
        out = []
        for j, (s, (f, ids, valid)) in enumerate(zip(local, slabs)):
            cat = [torch.cat([a, b, c]) for a, b, c in zip(f, from_l[j], from_r[j])]
            ids_f = torch.cat([
                torch.where(valid, ids.to(torch.float32), -1.0),
                torch.full((2 * self.halo_cap,), float(GHOST_ID),
                           dtype=torch.float32, device=self.device)])
            out.append((self._build_packed(cat, ids_f, self._shift(s)),
                        (ov_h[j], ov_mig[j], ov_cap[j]), strips[j]))
        return out

    def layouts(self, state: DomainState) -> list:
        """What the next step's kernels read, per slab of this process:
        (engine, packed state after the relayout, its TripleCtx)."""
        return [(eng, *eng._relayout(packed)[:2])
                for eng, (packed, _, _) in zip(self.engines, self._front(state))]

    def _pack_back(self, s: int, pk, acc):
        """Slab s's owned rows of a finished packed state, stable-packed into
        its slab arrays and shifted back to global x (`domain_window.py:
        333-344,694-705`): (fluid, ids, au, av, lane validity)."""
        owner = (pk[:, 7] >= 0.0) & (pk[:, 4] > 0)
        cols, valid, _ = _take_first(
            owner, [pk[:, j] for j in range(8)] + [acc[:, 0], acc[:, 1]],
            self.slab_cap)
        x = torch.where(valid, cols[0] + self._shift(s), cols[0])
        f = _inert(FluidState(x, *cols[1:7]), valid)
        return f, torch.where(valid, cols[7].to(_I32), -1), cols[8], cols[9], valid

    def _stats(self, rho_err, speed2, ov_all, n_valid, ov_by) -> dict:
        """Per-slab stats -> JAX's dict of cross-slab device tensors; the
        overflows are summed in int64 and saturated at the int32 maximum,
        where JAX's int32 ``psum`` (`domain_window.py:365,590`) wraps
        negative from three screaming slabs on."""
        comm = self.comm
        rho0 = float(np.float32(self.cfg.rho_0))
        err = comm.all_max(rho_err)
        return {
            "max_rho_error_pct":
                div_scalar(torch.clamp_min(err, 0.0), rho0)[0] * 100.0,
            "max_speed": torch.sqrt(comm.all_max(speed2)),
            "overflow": saturating_sum(comm, ov_all),
            "n_valid": comm.all_sum(n_valid),
            "overflow_by": saturating_sum(comm, ov_by),
        }

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
        half = float(np.float32(0.5) * np.float32(self.cfg.dt))
        damp = float(damping)
        rho0 = float(np.float32(self.cfg.rho_0))

        def step(state: DomainState, g):
            g = host_gravity(g)
            fluids, idss, aus, avs = [], [], [], []
            ov_all, ov_by, rho_err, speed2, n_valid = [], [], [], [], []
            for s, eng, (packed, (ov_h, ov_mig, ov_cap), _) in zip(
                    self.comm.slabs, self.engines, self._front(state)):
                pk, ctx, ov_w = eng._relayout(packed)
                # ghost densities are complete for every candidate an owned
                # query reaches (module docstring), so one exchange serves
                # both kernels; the forces kernel returns the finished state
                # (trailing half-kick and damping fused): cols 2-3 are the
                # new u, v and cols 5-6 the fresh rho, p
                pk, acc = eng._pair_acc(pk, ctx, g, half, damp)
                f, ids, au, av, valid = self._pack_back(s, pk, acc)
                fluids.append(f)
                idss.append(ids)
                aus.append(au)
                avs.append(av)

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
            stats = self._stats(rho_err, speed2, ov_all, n_valid, ov_by)
            return _join(fluids, idss, aus, avs), stats

        return step

    def make_multi_step(self, resort_every: int = 1, damping: float = 1.0):
        """``multi(state, g_trace) -> (state, stats)`` over a (K, 2) gravity
        trace, each stat stacked to (K,) and ``overflow_by`` to (K, 4).

        ``resort_every`` = k > 1 runs sticky groups (`domain_window.py:
        400-437`): K must be a multiple of k (else ``ValueError``), and the
        stats gain ``stale``, the drift guard's count, and are sampled:
        the first tick of a group reports its own, the middle ones zeros but
        ``stale``, the last the group's maxima, ``overflow`` and
        ``n_valid``."""
        k = int(resort_every)
        if k > 1:
            tick_fn, stack = self._make_group(k, damping), torch.cat
        else:
            k, tick_fn, stack = 1, self.make_step(damping), torch.stack

        def multi(state: DomainState, g_trace):
            g = host_gravity(g_trace)
            if g.shape[0] % k:
                raise ValueError(f"trace length {g.shape[0]} not a multiple of "
                                 f"resort_every={k}")
            out = []
            for i in range(0, g.shape[0], k):
                state, st = tick_fn(state, g[i:i + k] if k > 1 else g[i])
                out.append(st)
            return state, {key: stack([st[key] for st in out]) for key in out[0]}

        return multi

    def _make_group(self, k: int, damping: float = 1.0):
        """One sticky group of k ticks (`domain_window.py:439-734`):
        ``group(state, g_group) -> (state, stats)``, each stat (k,).

        Tick 0 is a full step (``_front``, one relayout a slab, both
        kernels).  The group's exchange plumbing is fixed from there: the
        layout slots of the rows each slab sent as ghosts and of the ghost
        rows it received.  A carried tick, per slab: kick and drift in
        layout space, the halo members' rows gathered and shifted to the
        neighbours, each ghost row's columns 0-3 overwritten with its
        owner's (x moved by one slab width into this slab's frame; columns
        4-7 kept), the 0.3*H drift guard over owned rows and ghosts, both
        kernels, the running maxima.  Ghosts drift between refreshes with
        their locally computed, wrong, accelerations: the next refresh
        overwrites them.  A carried tick reads nothing back to the host and
        reduces nothing across slabs; the group's end sums the per-tick
        ``stale`` counts in one call and packs the owned rows back."""
        cfg, comm, spec = self.cfg, self.comm, self.spec
        n, n_in = spec.n_layout, self.n_local
        hcap, scap = self.halo_cap, self.slab_cap
        dev = self.device
        oob = n + 7      # JAX's sentinel: gathers clamp it, scatters drop it
        dt = float(np.float32(cfg.dt))
        half = float(np.float32(0.5) * np.float32(cfg.dt))
        damp = float(damping)
        rho0 = float(np.float32(cfg.rho_0))
        margin2 = float(np.float32((0.3 * cfg.h) ** 2))
        cell = np.float32(cfg.cell_length)
        # a received row's x is in its sender's frame: the left neighbour's
        # is one slab width right of ours (`domain_window.py:612-616`)
        x_shift = torch.tensor(np.repeat([np.float32(-self.k_cols) * cell,
                                          np.float32(self.k_cols) * cell], hcap),
                               device=dev)
        slots = torch.arange(n, device=dev)

        def plumbing(pk, ctx, order, strips):
            """The carried ticks' fixed exchange slots of one slab: the
            gather slots of the rows it sends left then right and their
            validity, the gather slots of its ghost rows and their scatter
            slots (n, the buffer's spare row, for a ghost without a live
            slot)."""
            live = pk[:, 4] > 0
            # layout slot j holds input row order[layout_src[j]]; invert that
            # over the live slots (the JAX ride through column 5, :525-548)
            src = torch.cat([order, order.new_full((1,), n)])[ctx.layout_src.long()]
            slot_of = torch.full((n_in + 1,), oob, dtype=torch.int64, device=dev)
            slot_of[torch.where(live, src, n_in)] = slots
            slot_of = slot_of[:n_in]
            (idx_l, lv_l), (idx_r, lv_r) = (_first(m, hcap) for m in strips)
            send = torch.where(torch.cat([lv_l, lv_r]),
                               slot_of[torch.cat([idx_l, idx_r])], oob)
            ghost = slot_of[scap:]             # [from the left, from the right]
            return dict(send=send.clamp_max(n - 1), send_ok=(send < oob)[:, None],
                        ghost=ghost.clamp_max(n - 1),
                        ghost_to=torch.where(ghost < oob, ghost, n))

        def kick_drift(pk, acc):
            """Leading half-kick and drift of a finished state into a fresh
            (n + 1, 8) buffer; row n takes the scatter's dropped rows."""
            buf = torch.empty((n + 1, 8), dtype=pk.dtype, device=dev)
            b = buf[:n]
            torch.mul(acc, half, out=b[:, 2:4])
            b[:, 2:4] += pk[:, 2:4]
            torch.mul(b[:, 2:4], dt, out=b[:, 0:2])
            b[:, 0:2] += pk[:, 0:2]
            b[:, 4:] = pk[:, 4:]
            return buf

        def tick_stats(pk, live, rho_err, speed2, ov, ov_by):
            """One slab's sampled stats of a finished state: the non-finite
            scream reads every live row, ghosts included, as JAX does."""
            sp2 = pk[:, 2] * pk[:, 2] + pk[:, 3] * pk[:, 3]
            bad = torch.sum(live & ~torch.isfinite(pk[:, 0] + sp2 + pk[:, 5]),
                            dtype=_I32)
            if rho_err is None:
                rho_err = torch.max(torch.where(live, pk[:, 5] - rho0, -rho0))
                speed2 = torch.max(torch.where(live, sp2, 0.0))
            return (rho_err, speed2,
                    ov + torch.clamp_max(bad, 1000).to(torch.int64) * 1_000_000,
                    torch.sum(live & (pk[:, 7] >= 0.0), dtype=_I32), ov_by)

        def group(state: DomainState, g_group):
            slabs, first = [], []
            for eng, (packed, (ov_h, ov_mig, ov_cap), strips) in zip(
                    self.engines, self._front(state)):
                pk, ctx, ov_w, order = eng._relayout_order(packed)
                live = pk[:, 4] > 0
                sl = SimpleNamespace(eng=eng, ctx=ctx, live=live, xy0=pk[:, 0:2],
                                     stale=[], **plumbing(pk, ctx, order, strips))
                sl.pk, sl.acc = eng._pair_acc(pk, ctx, g_group[0], half, damp)
                by = torch.stack([ov_w.to(_I32), ov_h, ov_mig, ov_cap])
                first.append(tick_stats(sl.pk, live, None, None,
                                        by.to(torch.int64).sum(), by))
                zero = torch.zeros_like(pk[:, 5])
                sl.hi = _running_max(zero, zero, sl.pk, live)
                slabs.append(sl)

            for g in g_group[1:]:
                bufs = [kick_drift(sl.pk, sl.acc) for sl in slabs]
                sent = [torch.where(sl.send_ok, buf[sl.send], 0.0)
                        for sl, buf in zip(slabs, bufs)]
                # a slab's left-bound rows ride the leftward shift, so what
                # it receives through that shift comes from its right
                from_r = comm.shift([v[:hcap] for v in sent], -1)
                from_l = comm.shift([v[hcap:] for v in sent], +1)
                for sl, buf, a, b in zip(slabs, bufs, from_l, from_r):
                    rows = buf[sl.ghost]
                    rows[:, 0:4] = torch.cat([a, b])[:, 0:4]
                    rows[:, 0] += x_shift
                    buf.index_put_((sl.ghost_to,), rows)
                    pk = buf[:n]
                    dx, dy = (pk[:, 0:2] - sl.xy0).unbind(1)
                    sl.stale.append(torch.sum(sl.live & (dx * dx + dy * dy > margin2),
                                              dtype=_I32))
                    sl.pk, sl.acc = sl.eng._pair_acc(pk, sl.ctx, g, half, damp)
                    sl.hi = _running_max(*sl.hi, sl.pk, sl.live)

            fluids, idss, aus, avs, last = [], [], [], [], []
            zero64 = torch.zeros((), dtype=torch.int64, device=dev)
            no_by = torch.zeros(4, dtype=_I32, device=dev)
            for s, sl in zip(comm.slabs, slabs):
                rho_hi, sp2_hi = sl.hi
                last.append(tick_stats(sl.pk, sl.live, torch.max(rho_hi) - rho0,
                                       torch.max(sp2_hi), zero64, no_by))
                f, ids, au, av, _ = self._pack_back(s, sl.pk, sl.acc)
                fluids.append(f)
                idss.append(ids)
                aus.append(au)
                avs.append(av)
            st0, st1 = self._stats(*zip(*first)), self._stats(*zip(*last))
            stats = {key: torch.cat([st0[key][None],
                                     st0[key].new_zeros((k - 2,) + st0[key].shape),
                                     st1[key][None]]) for key in st0}
            stale = comm.all_sum([torch.stack(sl.stale) for sl in slabs])
            stats["stale"] = torch.cat([stale.new_zeros(1), stale])
            return _join(fluids, idss, aus, avs), stats

        return group

    # ------------------------------------------------------------------
    def _pixel_tables(self, rows: int, cols: int, qb: int, tq: int) -> dict:
        """The per-slab renderer's static tables, host numpy
        (`domain_window.py:773-799`): each slab owns the pixels whose global
        cell column is in its slab, laid out in its local frame; every slab
        padded to the largest layout with inert queries and blocks without
        queries.  ``q`` (d, n_layout, 8), ``c_first``/``c_last``/``has_q``
        (d, n_layout // qb), ``unsort`` (rows * cols,) the row of the slabs'
        gathered field that holds pixel i, ``n_layout``."""
        cfg, lcfg, d, k = self.cfg, self.lcfg, self.n_slabs, self.k_cols
        cell = np.float32(cfg.cell_length)
        px, py = pixel_centers(cfg, rows, cols)
        dest = np.clip(np.clip((px / cell).astype(np.int64), 0,
                               cfg.n_cell_cols - 1) // k, 0, d - 1)
        lays = []
        for s in range(d):
            sel = np.nonzero(dest == s)[0]
            shift = np.float32(s * k - self.HALO_CELLS) * cell
            lays.append((sel, pixel_layout(lcfg, (px[sel] - shift).astype(np.float32),
                                           py[sel].astype(np.float32), qb, tq)))
        n_layout = max(lay["n_layout"] for _, lay in lays)
        q = np.zeros((d, n_layout, 8), np.float32)
        q[:, :, 0:2] = INERT_PX
        c_first = np.full((d, n_layout // qb), lcfg.n_cells, np.int32)
        c_last = c_first.copy()
        has_q = np.zeros((d, n_layout // qb), bool)
        unsort = np.zeros(rows * cols, np.int64)
        for s, (sel, lay) in enumerate(lays):
            nl, nb = lay["n_layout"], lay["n_layout"] // qb
            q[s, :nl] = lay["q"]
            c_first[s, :nb] = lay["c_first"]
            c_last[s, :nb] = lay["c_last"]
            has_q[s, :nb] = lay["has_q"]
            unsort[sel] = s * n_layout + lay["slots"]
        return dict(q=q, c_first=c_first, c_last=c_last, has_q=has_q,
                    unsort=unsort, n_layout=n_layout)

    def make_render(self, rows: int = 64, cols: int = 128, qb: int = 8,
                    seg_q: int = 2):
        """The per-slab metaball renderer (`domain_window.py:737-881`):
        ``render(state) -> (page-packed uint8 framebuffer, overflow)`` on the
        domain's device.

        A frame, per slab: one [x, y, m] halo exchange of the 3-cell strips
        (a pixel's 2H support reaches one cell past the owned columns), x
        moved into the slab's frame, the slab-plus-halo rows sorted by
        local cell with their CSR as the start grid, and one field kernel
        launch over the sorted rows for the slab's own pixels, as
        ``WindowRenderer.field`` does.  The slabs' fields are gathered in
        slab order, put in pixel order through a static table, scaled,
        thresholded at 1 and page-packed as the single renderer does.  The
        overflow is each slab's fluid lanes of a pixel window beyond the
        cap (``WindowRenderer.field``'s count) plus its halo drops, summed
        over slabs without wrapping."""
        cfg, lcfg, comm = self.cfg, self.lcfg, self.comm
        dev, tq = self.device, max(qb, 64)
        tab = self._pixel_tables(rows, cols, qb, tq)
        q = torch.as_tensor(tab["q"], device=dev)
        span_idx = [span_index(lcfg, seg_q, *(torch.as_tensor(tab[key][s], device=dev)
                                              for key in ("c_first", "c_last", "has_q")))
                    for s in comm.slabs]
        unsort = torch.as_tensor(tab["unsort"], device=dev)
        cap = pixel_window_cap(cfg, cols, qb, seg_q)
        spec = triple_spec(lcfg, self.n_local, 0, tq, qb, cap, seg_q)._replace(
            n_layout=tab["n_layout"])
        scale = field_scale_of(cfg)
        n_cells = lcfg.n_cells

        def render(state: DomainState):
            fluids = [f for f, _, _, _ in _split(state, len(comm.slabs))]
            strips = [self._strips(s, f.x, f.m > 0) for s, f in zip(comm.slabs, fluids)]
            from_l, from_r, ov_h = _exchange(comm, [st[0] for st in strips],
                                             [st[1] for st in strips],
                                             [[f.x, f.y, f.m] for f in fluids],
                                             self.halo_cap)
            fields, overflow = [], []
            for j, (s, f) in enumerate(zip(comm.slabs, fluids)):
                x, y, m = (torch.cat([a, b, c]) for a, b, c in
                           zip((f.x, f.y, f.m), from_l[j], from_r[j]))
                live = m > 0
                x = torch.where(live, x - self._shift(s), x)
                keys = torch.where(live, cell_ids(x, y, lcfg),
                                   torch.full_like(m, n_cells, dtype=_I32))
                order = torch.argsort(keys, stable=True)
                # bins through n_cells, so that the last grid row has its end
                grid = start_grid(lcfg, csr_starts(keys, n_cells + 1))
                z = torch.zeros_like(x)
                src = torch.stack([x, y, z, z, m, z, z, z], 1)[order]
                w_len = (grid[span_idx[j][:, :, 1]] - grid[span_idx[j][:, :, 0]]).sum(1)
                raw = torch.sum(torch.clamp_min(w_len - cap, 0).to(torch.float32))
                overflow.append(torch.clamp_max(raw, 1e8).to(_I32) + ov_h[j])
                fields.append(field_window(q[s], src, grid, span_idx[j], lcfg, spec))
            field = comm.all_gather(fields)[unsort] * scale
            lit = (field >= 1.0).reshape(rows, cols)
            return pack_framebuffer(lit, rows, cols), saturating_sum(comm, overflow)

        return render

    # ------------------------------------------------------------------
    def gather(self, state: DomainState) -> FluidState:
        """The global fluid state in original id order, on every process."""
        return gather_by_id(whole_state(self.comm, state))[0]

    def export(self, state: DomainState):
        """(fluid, au, av) in original id order, on every process: a
        lossless checkpoint with the leapfrog acceleration carry;
        ``init(fluid, au, av)`` of this domain or of one with other
        capacities resumes it exactly."""
        whole = whole_state(self.comm, state)
        return gather_by_id(whole, (whole.au, whole.av))
