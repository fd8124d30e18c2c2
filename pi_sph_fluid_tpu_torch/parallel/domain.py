"""Slab domain decomposition over the jnp-oracle passes (port of
`pi_sph_fluid_tpu/parallel/domain.py:48-382`).

The x-axis is cut into d slabs.  Each slab owns the particles inside it in
fixed-capacity arrays and, every step, trades with its two neighbours
through a ``Comm`` (parallel/comm.py):

* **migration**: particles that drifted across a slab edge move to the
  neighbour (x, y, u, v, m, rho, p and the int32 id; accelerations are
  recomputed);
* **halo exchange**: particles within 2H of a slab edge are copied to the
  neighbour as read-only ghosts, once before the density pass (positions)
  and again before the force pass (fresh rho and p).

Every buffer has a fixed capacity and counts what it drops; slot validity
is m > 0, so a zero-filled edge buffer and a padded lane are inert in every
pair sum.  The pair passes are the oracle's (ops/density.py, ops/forces.py,
ops/neighbors.py), so this is the check of the exchange machinery on
physics that is held against JAX already; parallel/domain_window.py runs
the window kernels under the same machinery.

State layout: JAX's flat (d * slab_cap,) arrays, slab i the view
[i * slab_cap, (i + 1) * slab_cap), so that a JAX ``DomainState`` carries
across as it is (convert.domain_state) and slabs compare lane for lane.
A process holds the slabs of ``comm.slabs`` (all of them under
``LocalComm``, its share under ``DistComm``), in that layout over its
share; a step is a loop over them between exchanges, on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SPHConfig
from ..core.eos import tait_pressure
from ..core.kernels import div_scalar
from ..models.simulation import host_gravity
from ..ops.density import density_pass
from ..ops.forces import acceleration_pass
from ..ops.grid import GridContext, cell_ids, csr_starts
from ..ops.neighbors import gather_candidates, span_overflow
from ..state import BoundaryState, FluidState
from .comm import Comm

__all__ = ["DomainState", "DomainDecomposition", "INERT_X", "saturating_sum",
           "whole_state"]

INERT_X = -1e6
_I32 = torch.int32
_I32_MAX = (1 << 31) - 1


class DomainState(NamedTuple):
    """Decomposed simulation state: every tensor is (d * slab_cap,), slab i
    the slots [i * slab_cap, (i + 1) * slab_cap); slot validity is m > 0,
    ``ids`` is int32 with -1 on free slots."""

    fluid: FluidState
    ids: torch.Tensor
    au: torch.Tensor
    av: torch.Tensor


def _masked_grid(x, y, valid, cfg: SPHConfig) -> GridContext:
    """build_grid with invalid slots forced to the out-of-range key, so they
    sort last and join no cell span (`domain.py:61-69`)."""
    keys = torch.where(valid, cell_ids(x, y, cfg),
                       torch.full_like(x, cfg.n_cells, dtype=_I32))
    order = torch.argsort(keys, stable=True).to(_I32)
    return GridContext(order=order, sorted_cells=keys[order.long()],
                       cell_starts=csr_starts(keys, cfg.n_cells + 2))


def _first(mask, cap: int):
    """The slots of the first ``cap`` lanes of a stable pack of ``mask``
    (set slots first, in order) and each lane's validity; a source shorter
    than ``cap`` pads to ``cap`` (`domain.py:82-92`): receive buffers are
    sized by capacity, never by source."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    n = mask.shape[0]
    if cap > n:
        return (torch.cat([order, order.new_zeros(cap - n)]),
                torch.cat([mask[order], mask.new_zeros(cap - n)]))
    idx = order[:cap]
    return idx, mask[idx]


def _take_first(mask, arrays, cap: int):
    """Stable-pack the slots where ``mask`` holds into the first ``cap``
    lanes (`domain.py:72-106`, through ``_first``).  Returns (packed
    arrays, lane validity, overflow count).  Arrays of one dtype are
    stacked and gathered as rows, one gather each."""
    idx, lane_valid = _first(mask, cap)
    packed = [None] * len(arrays)
    for dtype in {a.dtype for a in arrays}:
        cols = [i for i, a in enumerate(arrays) if a.dtype == dtype]
        rows = torch.stack([arrays[i] for i in cols], 1)[idx]
        rows = torch.where(lane_valid[:, None], rows, torch.zeros_like(rows[:1]))
        for j, i in enumerate(cols):
            packed[i] = rows[:, j]
    overflow = torch.clamp_min(torch.sum(mask, dtype=_I32) - cap, 0)
    return packed, lane_valid, overflow


def _per_slab(lists) -> list:
    """[field][slab] -> [slab][field]."""
    return [list(t) for t in zip(*lists)]


def _exchange(comm: Comm, masks_l, masks_r, arrays, cap: int):
    """Pack each slab's left- and right-bound slots (``_take_first`` into
    ``cap``) and shift them to the neighbours (`domain.py:115-127`).
    ``masks_*`` and ``arrays`` are per slab.  Returns, per slab, the arrays
    received from the left neighbour, those from the right neighbour, and
    the overflow of both packs.

    A slab's left-bound buffer must land on slab i-1, so it rides the
    leftward shift, and what a slab receives through that shift is its
    RIGHT neighbour's left-bound buffer (`:118-121`)."""
    left, right, ov = [], [], []
    for ml, mr, arr in zip(masks_l, masks_r, arrays):
        lo, _, ov_l = _take_first(ml, arr, cap)
        hi, _, ov_r = _take_first(mr, arr, cap)
        left.append(lo)
        right.append(hi)
        ov.append(ov_l + ov_r)
    from_right = _per_slab([comm.shift(list(f), -1) for f in zip(*left)])
    from_left = _per_slab([comm.shift(list(f), +1) for f in zip(*right)])
    return from_left, from_right, ov


def _inert(fluid: FluidState, valid) -> FluidState:
    """Invalid slots forced to the inert pattern: m = 0, far away, at rest
    (`domain.py:130-140`)."""
    far, zero = INERT_X, 0.0
    return FluidState(*(torch.where(valid, f, far if j < 2 else zero)
                        for j, f in enumerate(fluid)))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def saturating_sum(comm: Comm, counts: list) -> torch.Tensor:
    """The cross-slab sum of int32 counts in int64, saturated at the int32
    maximum, as int32.  JAX's ``psum`` of the slabs' int32 counts
    (`domain_window.py:365`) wraps negative once three slabs each scream
    their most, 1000 x 1e6 for non-finite rows; below the int32 maximum the
    two sums are equal."""
    total = comm.all_sum([c.to(torch.int64) for c in counts])
    return torch.clamp_max(total, _I32_MAX).to(_I32)


def _split(state: DomainState, n: int):
    """Per-slab views: [(FluidState, ids, au, av)] of the n slabs the state
    holds, in order."""
    fields = [f.view(n, -1).unbind(0) for f in state.fluid]
    ids = state.ids.view(n, -1).unbind(0)
    au = state.au.view(n, -1).unbind(0)
    av = state.av.view(n, -1).unbind(0)
    return [(FluidState(*(f[s] for f in fields)), ids[s], au[s], av[s])
            for s in range(n)]


def _join(fluids, ids, au, av) -> DomainState:
    return DomainState(fluid=FluidState(*(torch.cat(f) for f in zip(*fluids))),
                       ids=torch.cat(ids), au=torch.cat(au), av=torch.cat(av))


def _distribute(fluid: FluidState, dest: np.ndarray, slabs: range, cap: int,
                device, au=None, av=None) -> DomainState:
    """Host-side init shared by both decompositions (`domain.py:182-207`,
    `domain_window.py:196-232`): the particles of slab ``dest == s`` into
    slab s's first lanes in id order, the rest inert, for each s in
    ``slabs`` (the slabs this process holds).  ``fluid`` and ``dest`` are
    global, so every process raises alike when any slab is over capacity."""
    count = np.bincount(dest, minlength=slabs.stop)
    if count.max(initial=0) > cap:
        s = int(np.nonzero(count > cap)[0][0])
        raise ValueError(f"slab {s} over capacity: {count[s]} > {cap}")
    d = len(slabs)
    src = {f: _np(getattr(fluid, f)) for f in FluidState._fields}
    out = {f: np.zeros((d, cap), np.float32) for f in FluidState._fields}
    out["x"][:] = INERT_X
    out["y"][:] = INERT_X
    acc = np.zeros((2, d, cap), np.float32)
    ids = np.full((d, cap), -1, np.int32)
    for j, s in enumerate(slabs):
        sel = np.nonzero(dest == s)[0]
        for f in FluidState._fields:
            out[f][j, :len(sel)] = src[f][sel]
        if au is not None:
            acc[0, j, :len(sel)] = _np(au)[sel]
            acc[1, j, :len(sel)] = _np(av)[sel]
        ids[j, :len(sel)] = sel

    def put(a):
        return torch.from_numpy(a.reshape(-1)).to(device)

    return DomainState(fluid=FluidState(**{f: put(out[f]) for f in FluidState._fields}),
                       ids=put(ids), au=put(acc[0]), av=put(acc[1]))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def whole_state(comm: Comm, state: DomainState) -> DomainState:
    """The state of all d slabs from this process's share of them, on every
    process (``comm.all_gather`` of each array; JAX's ``to_host``,
    `domain_window.py:880-914`).  A comm that holds every slab returns
    ``state`` itself."""
    n = len(comm.slabs)
    if n == comm.d:
        return state

    def whole(t):
        return comm.all_gather(list(t.view(n, -1).unbind(0)))

    return DomainState(fluid=FluidState(*(whole(f) for f in state.fluid)),
                       ids=whole(state.ids), au=whole(state.au), av=whole(state.av))


def gather_by_id(state: DomainState, extra=()):
    """The valid slots of ``state`` (every slab's) in original id order:
    (FluidState, *the ``extra`` slab arrays), on the state's device
    (`domain.py:371-378`)."""
    ids = state.ids
    sel = torch.nonzero(ids >= 0).reshape(-1)
    inv = sel[torch.argsort(ids[sel])]
    return (FluidState(*(f[inv] for f in state.fluid)),) + tuple(e[inv] for e in extra)


class DomainDecomposition:
    """Slab decomposition over the oracle passes (`domain.py:143-378`).
    Slabs are ``cfg.width / d`` wide; the slabs of ``comm.slabs`` step in
    this process through ``comm``, on ``device``."""

    def __init__(self, cfg: SPHConfig, boundary: BoundaryState,
                 boundary_grid: GridContext, n_global: int, comm: Comm, device,
                 slab_cap: int | None = None, mig_cap: int | None = None,
                 halo_cap: int | None = None):
        self.cfg = cfg
        self.comm = comm
        self.device = torch.device(device)
        self.boundary = BoundaryState(*(f.to(self.device) for f in boundary))
        self.b_grid = GridContext(*(t.to(self.device) for t in boundary_grid))
        d = self.n_slabs = comm.d
        self.slab_w = cfg.width / d

        # Capacities are physical area bounds, not averages (`domain.py:
        # 164-179`): a slab holds at most its area / R^2 times a compression
        # slack, the 2H halo strip likewise; a step moves a particle at
        # most H/10 (the C/10 speed bound), so migration is an H strip.
        def area_cap(strip_w: float, slack: float = 1.35) -> int:
            return int(strip_w * cfg.height / (cfg.r * cfg.r) * slack) + 1

        self.slab_cap = slab_cap or _round_up(
            min(area_cap(self.slab_w), n_global) + 64, 128)
        self.halo_cap = halo_cap or _round_up(
            min(area_cap(2 * cfg.h), n_global) + 64, 64)
        self.mig_cap = mig_cap or _round_up(
            min(area_cap(cfg.h), n_global) + 64, 64)

    # ------------------------------------------------------------------
    def init(self, fluid: FluidState) -> DomainState:
        """Distribute a global FluidState (the same on every process) into
        the slab arrays of this process's slabs."""
        x = _np(fluid.x)
        dest = np.clip((x / self.slab_w).astype(np.int64), 0, self.n_slabs - 1)
        return _distribute(fluid, dest, self.comm.slabs, self.slab_cap, self.device)

    # ------------------------------------------------------------------
    def _halo_masks(self, fluid: FluidState, valid, s: int):
        x_lo = np.float32(s) * np.float32(self.slab_w)
        x_hi = x_lo + np.float32(self.slab_w)
        strip = np.float32(self.cfg.support_radius)
        return (valid & (fluid.x < float(x_lo + strip)),
                valid & (fluid.x > float(x_hi - strip)))

    def _combined_pass(self, slabs, pass_fn):
        """Halo exchange, ghosts merged, cell sort, pair pass, per slab
        (`domain.py:221-246`).  ``slabs`` is [(fluid, ids, valid)]; ids and
        the owner mask ride the sort so identity survives it.  Returns per
        slab (combined fluid sorted, combined ids, owner mask, pass result,
        overflow)."""
        cfg, halo_cap = self.cfg, self.halo_cap
        masks = [self._halo_masks(f, v, s) for s, (f, _, v) in zip(self.comm.slabs, slabs)]
        from_l, from_r, ov_h = _exchange(self.comm, [m[0] for m in masks],
                                         [m[1] for m in masks],
                                         [list(f) for f, _, _ in slabs], halo_cap)
        out = []
        for s, (f, ids, _) in enumerate(slabs):
            comb = FluidState(*(torch.cat([a, b, c])
                                for a, b, c in zip(f, from_l[s], from_r[s])))
            comb_ids = torch.cat([ids, ids.new_full((2 * halo_cap,), -1)])
            owner = torch.cat([torch.ones_like(ids, dtype=torch.bool),
                               ids.new_zeros(2 * halo_cap, dtype=torch.bool)])
            grid = _masked_grid(comb.x, comb.y, comb.m > 0, cfg)
            order = grid.order.long()
            comb = comb.permute(order)
            cand_ff = gather_candidates(comb.x, comb.y, grid, cfg)
            cand_fb = gather_candidates(comb.x, comb.y, self.b_grid, cfg)
            ov = (ov_h[s] + span_overflow(comb.x, comb.y, grid, cfg)
                  + span_overflow(comb.x, comb.y, self.b_grid, cfg))
            out.append((comb, comb_ids[order], owner[order],
                        pass_fn(comb, cand_ff, cand_fb), ov))
        return out

    def _drop_ghosts(self, comb: FluidState, comb_ids, owner, extras=()):
        """Keep the owned valid slots (a stable pack: still cell-sorted in
        the slab), padded back to slab_cap (`domain.py:248-257`).  Returns
        (fluid, ids, packed extras, lane validity)."""
        arrays = list(comb) + [comb_ids] + list(extras)
        packed, lane_valid, _ = _take_first(owner & (comb.m > 0), arrays,
                                            self.slab_cap)
        fluid = _inert(FluidState(*packed[:7]), lane_valid)
        ids = torch.where(lane_valid, packed[7], -1)
        return fluid, ids, packed[8:], lane_valid

    # ------------------------------------------------------------------
    def make_step(self):
        """``step(DomainState, g) -> (DomainState, stats)`` (`domain.py:
        260-368`); stats is JAX's dict of device scalars."""
        cfg, comm, d = self.cfg, self.comm, self.n_slabs
        local = comm.slabs
        dt = float(np.float32(cfg.dt))
        half = float(np.float32(0.5) * np.float32(cfg.dt))
        rho0 = float(np.float32(cfg.rho_0))

        def step(state: DomainState, g):
            g = host_gravity(g)
            fluids, idss, go_l, go_r, stays = [], [], [], [], []
            for s, (f, ids, au, av) in zip(local, _split(state, len(local))):
                valid = f.m > 0
                # kick + drift (`pi_sph_fluid.c:614-624`)
                u = f.u + half * au
                v = f.v + half * av
                f = f._replace(x=torch.where(valid, f.x + dt * u, f.x),
                               y=torch.where(valid, f.y + dt * v, f.y),
                               u=torch.where(valid, u, 0.0),
                               v=torch.where(valid, v, 0.0))
                q = torch.clamp(div_scalar(f.x, self.slab_w), -1.0, float(d))
                dest = torch.clamp(q.to(_I32), 0, d - 1)
                go_l.append(valid & (dest < s))
                go_r.append(valid & (dest > s))
                stays.append(valid & ~(go_l[-1] | go_r[-1]))
                fluids.append(f)
                idss.append(ids)

            # migration: slab-crossers move to the neighbour; ids travel as
            # int32 (a float round trip would corrupt ids above 2^24)
            from_l, from_r, ov_mig = _exchange(
                comm, go_l, go_r, [list(f) + [i] for f, i in zip(fluids, idss)],
                self.mig_cap)
            slabs, ov_cap = [], []
            for j in range(len(local)):
                f = _inert(fluids[j], stays[j])
                ids = torch.where(stays[j], idss[j], -1)
                merged = [torch.cat([a, b, c]) for a, b, c in
                          zip(list(f) + [ids], from_l[j], from_r[j])]
                packed, lane_valid, ov = _take_first(merged[4] > 0, merged,
                                                     self.slab_cap)
                slabs.append((_inert(FluidState(*packed[:7]), lane_valid),
                              torch.where(lane_valid, packed[7], -1), lane_valid))
                ov_cap.append(ov)

            # phase 1: density + EOS on the slab and its position ghosts
            def density_fn(comb, cand_ff, cand_fb):
                rho = density_pass(comb, self.boundary, cand_ff, cand_fb, cfg)
                return rho, tait_pressure(rho, cfg)

            ov_d, nxt = [], []
            for comb, comb_ids, owner, (rho, p), ov in self._combined_pass(
                    slabs, density_fn):
                fluid, ids, _, valid = self._drop_ghosts(
                    comb._replace(rho=rho, p=p), comb_ids, owner)
                nxt.append((fluid, ids, valid))
                ov_d.append(ov)

            # phase 2: forces on the slab and its rho/p ghosts
            def force_fn(comb, cand_ff, cand_fb):
                # pad slots (rho = 0) must not divide 0 by 0 in the pressure
                safe = comb._replace(rho=torch.where(comb.rho > 0, comb.rho, 1.0))
                return acceleration_pass(safe, self.boundary, cand_ff, cand_fb,
                                         float(g[0]), float(g[1]), cfg)

            fluids, idss, aus, avs, ov_all, rho_err, speed2, n_valid = \
                [], [], [], [], [], [], [], []
            for j, (comb, comb_ids, owner, (au, av), ov_f) in enumerate(
                    self._combined_pass(nxt, force_fn)):
                fluid, ids, (au, av), valid = self._drop_ghosts(
                    comb, comb_ids, owner, (au, av))
                # kick with the new accelerations
                fluid = fluid._replace(
                    u=torch.where(valid, fluid.u + half * au, 0.0),
                    v=torch.where(valid, fluid.v + half * av, 0.0))
                fluids.append(fluid)
                idss.append(ids)
                aus.append(au)
                avs.append(av)
                ov_all.append(ov_mig[j] + ov_cap[j] + ov_d[j] + ov_f)
                rho_err.append(torch.max(torch.where(valid, fluid.rho - rho0, -rho0)))
                speed2.append(torch.max(torch.where(
                    valid, fluid.u * fluid.u + fluid.v * fluid.v, 0.0)))
                n_valid.append(torch.sum(valid, dtype=_I32))
            err = comm.all_max(rho_err)
            stats = {
                "max_rho_error_pct":
                    div_scalar(torch.clamp_min(err, 0.0), rho0)[0] * 100.0,
                "max_speed": torch.sqrt(comm.all_max(speed2)),
                "overflow": saturating_sum(comm, ov_all),
                "n_valid": comm.all_sum(n_valid),
            }
            return _join(fluids, idss, aus, avs), stats

        return step

    # ------------------------------------------------------------------
    def gather(self, state: DomainState) -> FluidState:
        """The global fluid state in original id order, on every process."""
        return gather_by_id(whole_state(self.comm, state))[0]
