"""Window-kernel metaball renderer: the production raster path (port of
`pi_sph_fluid_tpu/render/metaballs_window.py:45-372`).

Same math as render/metaballs.py (field = sum_j W_ij / W(px_width/2), lit
when >= 1, `pi_sph_fluid.c:380-411`) over the row-triple layout: pixel
centers are static queries (the reference's pixels-as-particles trick,
`pi_sph_fluid.c:570-577`), laid out once into qb-quantised grid-row blocks,
and the field kernel sums unweighted Wendland terms per pixel over its
block's window of fluid candidates.

The window is read as spans straight from the (n, 8) packed rows: for each
grid row of the block's segment, the cells [c_first - 1, c_last + 1] are one
run of rows.  A pixel block's cells never change, so its index pairs into a
per-cell start grid (ops/window/triple.py::span_index) are built once per
renderer, and a frame needs only the start grid of the rows it draws from:

* ``field`` sorts the fluid from live positions (exact for any state): one
  argsort, one CSR, the rows in sorted order, the CSR as the start grid;
* ``field_from_frame`` takes the ``Frame`` of
  ``WindowEngine.make_multi_step(return_frame=True)``, the engine's last
  relayout: no sort and no other preparation per frame.  Under a sticky
  layout the spans are the relayout's and the rows the tick's.

Boundary lanes add nothing to the field, so the kernel reads none; window
overflow still counts the whole window (fluid and boundary lanes of
``T[c_last, 1] - T[c_first, 0]``) beyond the pixel cap, plus x1e6 for an
L-budget overrun, as the JAX renderer does, and is returned with every
frame, never silent.  Up to the cap no lane is cut; past it the kernel
keeps the first cap fluid lanes in span order.

``field_window`` launches the CUDA kernel (csrc/window_kernels.cu) on CUDA
tensors and runs ``field_window_plain`` on CPU tensors; it counts its
kernel launches, and nothing else, as ``kernel.field.launches`` of
utils/tracer.py's counters.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SPHConfig
from ..models.scene import pixel_centers
from ..ops.grid import cell_ids, csr_starts
from ..ops.window.triple import (LANE, Frame, TripleSpec, span_index,
                                 start_grid, triple_spec)
from ..ops.window.window_kernels import (_check_grid_spans, _chunk,
                                         _grid_spans, _lanes, _launch, _zero,
                                         density_consts)
from ..utils.tracer import tracer
from .metaballs import pack_framebuffer, w_ref_of

__all__ = ["WindowRenderer", "pixel_layout", "pixel_window_cap",
           "pixel_windows", "field_scale_of", "field_window",
           "field_window_plain"]

INERT_PX = -1e6
_I32 = torch.int32


def pixel_layout(cfg: SPHConfig, px: np.ndarray, py: np.ndarray, qb: int,
                 tq: int) -> dict:
    """Static qb-quantised per-grid-row pixel layout, host numpy, bitwise
    JAX's (`metaballs_window.py:45-90`).  Blocks never straddle grid rows,
    so each block's candidates are one contiguous window.  Returns ``q``
    (n_layout, 8) packed queries, ``slots`` (len(px),) the layout slot of
    input pixel i, ``c_first``/``c_last``/``has_q`` per block, and
    ``n_layout``."""
    keys = cell_ids(torch.as_tensor(px), torch.as_tensor(py), cfg).numpy()
    order = np.argsort(keys, kind="stable")
    px_s, py_s, keys_s = px[order], py[order], keys[order]
    grow = keys_s // cfg.n_cell_cols                       # non-decreasing
    row_count = np.bincount(grow, minlength=cfg.n_cell_rows)
    rowcap = -(-row_count // qb) * qb
    rstart = np.concatenate([[0], np.cumsum(rowcap)])
    n_layout = int(-(-max(rstart[-1], 1) // tq) * tq)
    # sorted pixel j goes to its row's start plus its rank within the row
    rank = np.arange(len(keys_s)) - np.searchsorted(grow, grow, side="left")
    slot_s = rstart[grow] + rank
    q = np.zeros((n_layout, 8), np.float32)
    q[:, 0:2] = INERT_PX
    q[slot_s, 0] = px_s
    q[slot_s, 1] = py_s
    q[slot_s, 4] = 1.0
    cells_px = np.full(n_layout, cfg.n_cells, np.int32)
    cells_px[slot_s] = keys_s
    slots = np.zeros(len(px), np.int32)
    slots[order] = slot_s

    cb = cells_px.reshape(n_layout // qb, qb)
    has_q = (cb < cfg.n_cells).any(axis=1)
    c_first = np.where(has_q, cb[:, 0], cfg.n_cells)
    c_last = np.where(has_q, np.max(np.where(cb < cfg.n_cells, cb, -1), axis=1),
                      cfg.n_cells)
    return dict(q=q, slots=slots, c_first=c_first.astype(np.int32),
                c_last=c_last.astype(np.int32), has_q=has_q, n_layout=n_layout)


def pixel_window_cap(cfg: SPHConfig, cols: int, qb: int, seg_q: int) -> int:
    """Window lane capacity of a pixel block: its extent in cells x segment
    cover rows x max cell occupancy (`metaballs_window.py:93-100`)."""
    px_pitch = cfg.width / cols
    cells_per_blk = qb * px_pitch / cfg.cell_length + 4
    per_cell = (cfg.cell_length / cfg.r) ** 2 * 1.5
    cap = int(cells_per_blk * (seg_q + 2) * per_cell) + 2 * LANE
    return -(-cap // LANE) * LANE


def pixel_windows(T: torch.Tensor, c_first: torch.Tensor, c_last: torch.Tensor,
                  has_q: torch.Tensor, cap: int, n_cells: int):
    """Exact-start windows of the pixel blocks from the per-cell table T:
    (w_start, w_len, overflow), the first two flat (blocks,) int32.
    Overflow is the saturating f32 sum of w_len beyond cap, plus x1e6 for
    the L-budget excess that build_frame stashes at T[n_cells, 2]."""
    t_lo = T[c_first.long()]                                # cells <= n_cells
    t_hi = T[c_last.long()]
    zero = torch.zeros_like(c_first)
    w_start = torch.where(has_q, t_lo[:, 0], zero)
    w_len = torch.where(has_q, t_hi[:, 1] - t_lo[:, 0], zero)
    raw = torch.sum(torch.clamp_min(w_len - cap, 0).to(torch.float32))
    overflow = torch.clamp_max(raw, 1e8).to(_I32)
    overflow = overflow + torch.clamp_max(T[n_cells, 2], 1000) * 1_000_000
    return w_start, w_len, overflow


def field_scale_of(cfg: SPHConfig) -> float:
    """1/W(px_width/2) times the kernel norm, always at the reference's
    128-column pitch (`metaballs_window.py:153-161`, kept for parity at every
    raster width); at fine resolutions where W(px/2) = 0 it degenerates to
    'any particle in support lights the pixel'."""
    w_ref = w_ref_of(cfg)
    if w_ref <= 0.0:
        w_ref = float(np.float32(1e-30))
    return float(np.float32(cfg.kernel_norm) / np.float32(w_ref))


# ---------------------------------------------------------------------------
# the field kernel
# ---------------------------------------------------------------------------


def field_window_plain(q_packed, rows, grid, span_idx, cfg: SPHConfig,
                       spec: TripleSpec):
    """Plain PyTorch version of the field kernel: the same lanes (the first
    min(sum of span lengths, cap) rows under the block's spans, in span
    order), the same per-lane operation order.  Returns the unnormalised
    field per layout slot, (n_layout,) float32."""
    c = density_consts(cfg)
    n_blocks, qb = spec.n_layout // spec.qb, spec.qb
    out = torch.empty(spec.n_layout, dtype=torch.float32, device=q_packed.device)
    step = _chunk(spec)
    for b0 in range(0, n_blocks, step):
        b1 = min(b0 + step, n_blocks)
        idx, valid = _lanes(*_grid_spans(span_idx[b0:b1], grid, rows.shape[0]),
                            spec.cap)
        cand = rows[idx]                                    # (nb, lanes, 8)
        q = q_packed[b0 * qb:b1 * qb].reshape(b1 - b0, qb, 8)
        dx = q[:, :, 0:1] - cand[:, None, :, 0]
        dy = q[:, :, 1:2] - cand[:, None, :, 1]
        r = torch.sqrt(dx * dx + dy * dy)
        t1 = torch.clamp_min(1.0 - c["half_inv_h"] * r, 0.0)
        t1sq = t1 * t1
        gate = torch.where(cand[:, None, :, 4] > 0.0, 1.0, 0.0)
        term = (gate * (t1sq * t1sq)) * (1.0 + c["two_inv_h"] * r)
        term = torch.where(valid[:, None, :], term, _zero(term))
        out[b0 * qb:b1 * qb] = term.sum(-1).reshape(-1)
    return out


def field_window(q_packed, rows, grid, span_idx, cfg: SPHConfig,
                 spec: TripleSpec):
    """Unnormalised pixel field (n_layout,) over the fluid rows ``rows``
    (n, 8) [x, y, u, v | m, ...]: span k of pixel block b is rows
    [grid[i_lo], grid[i_hi]) for ``span_idx[b, k] = [i_lo, i_hi]``
    (ops/window/triple.py: ``start_grid``, ``span_index``).  ``rows`` and
    ``grid`` may be those of a part of a domain.  The kernel on CUDA
    tensors, the plain version on CPU ones."""
    dev = _check_grid_spans(spec, q_packed, rows, grid, span_idx)
    if dev.type == "cpu":
        return field_window_plain(q_packed, rows, grid, span_idx, cfg, spec)
    if dev.type != "cuda":
        raise ValueError(f"no window kernel for device {dev}")
    fn, stream = _launch("field_window", dev)
    out = torch.empty(spec.n_layout, dtype=torch.float32, device=dev)
    c = density_consts(cfg)
    err = fn(q_packed.data_ptr(), rows.data_ptr(), grid.data_ptr(),
             span_idx.data_ptr(), out.data_ptr(), spec.n_layout // spec.qb,
             spec.qb, spec.cap, spec.seg_q + 2, rows.shape[0], grid.shape[0],
             c["half_inv_h"], c["two_inv_h"], stream)
    if err:
        raise RuntimeError(f"field_window kernel launch failed: CUDA error {err}")
    tracer.count("kernel.field.launches")
    return out


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------


class WindowRenderer:
    """``render(sim)`` / ``render_from_frame(sim, frame)`` -> (page-packed
    uint8 framebuffer, window overflow), on the engine's device."""

    def __init__(self, engine, rows: int = 64, cols: int = 128, qb: int = 8,
                 seg_q: int = 2):
        cfg = engine.cfg
        dev = engine.device
        self.cfg, self.rows, self.cols = cfg, rows, cols
        self.field_scale = field_scale_of(cfg)
        # tq only sizes n_layout here; kept at JAX's value (`:230`) so that
        # the pixel layout is bitwise the JAX renderer's
        tq = max(qb, 64)
        px, py = pixel_centers(cfg, rows, cols)
        lay = pixel_layout(cfg, px, py, qb, tq)
        self.q_packed = torch.as_tensor(lay["q"], device=dev)
        self.unsort = torch.as_tensor(lay["slots"], device=dev).long()
        self.c_first = torch.as_tensor(lay["c_first"], device=dev)
        self.c_last = torch.as_tensor(lay["c_last"], device=dev)
        self.has_q = torch.as_tensor(lay["has_q"], device=dev)
        n_layout = lay["n_layout"]
        # self-relayout mode: the renderer's own segment height, and the
        # pixel bound for it as the cap
        cap = pixel_window_cap(cfg, cols, qb, seg_q)
        self.spec = triple_spec(cfg, engine.n_real, 0, tq, qb, cap,
                                seg_q)._replace(n_layout=n_layout)
        # frame-reuse mode: pixel windows over the engine's segments, the
        # cap re-derived for the engine's segment height
        self.reuse_spec = engine.spec._replace(
            n_layout=n_layout, tq=tq, qb=qb,
            cap=pixel_window_cap(cfg, cols, qb, engine.spec.seg_q))
        # the pixel blocks' cells are static, so their index pairs into a
        # start grid are too: one table per segment height
        cells = (self.c_first, self.c_last, self.has_q)
        self.span_idx = span_index(cfg, seg_q, *cells)
        self.reuse_span_idx = self.span_idx if engine.spec.seg_q == seg_q else \
            span_index(cfg, engine.spec.seg_q, *cells)

    def _field(self, rows, grid, span_idx, spec: TripleSpec):
        out = field_window(self.q_packed, rows, grid, span_idx, self.cfg, spec)
        return out[self.unsort] * self.field_scale

    def field(self, sim):
        """(row-major pixel field, window overflow), sorting the fluid from
        live positions: exact for any state (`:268-305`).  The sorted rows
        are the kernel's source and their CSR its start grid; the overflow
        counts the fluid lanes of a window beyond the cap (this mode has no
        boundary lanes and no candidate-array budget to overrun)."""
        cfg, spec = self.cfg, self.spec
        packed = sim.packed
        keys = torch.where(packed[:, 4] > 0, cell_ids(packed[:, 0], packed[:, 1], cfg),
                           torch.full_like(packed[:, 4], cfg.n_cells, dtype=_I32))
        order = torch.argsort(keys, stable=True)
        # bins through n_cells, so that the last grid row has its end
        grid = start_grid(cfg, csr_starts(keys, cfg.n_cells + 1))
        w_len = (grid[self.span_idx[:, :, 1]] - grid[self.span_idx[:, :, 0]]).sum(1)
        raw = torch.sum(torch.clamp_min(w_len - spec.cap, 0).to(torch.float32))
        overflow = torch.clamp_max(raw, 1e8).to(_I32)
        return self._field(packed[order], grid, self.span_idx, spec), overflow

    def field_from_frame(self, sim, frame: Frame):
        """(row-major pixel field, overflow) over the engine's relayout frame
        instead of a sort per frame (`:308-355`).  Exact when the frame is
        layout-fresh; under sticky layouts it is at most resort_every - 1
        ticks stale, which can only miss particles in the outer fringe of a
        pixel's support, the bound the physics runs under."""
        spec = self.reuse_spec
        _, _, overflow = pixel_windows(frame.T, self.c_first, self.c_last,
                                       self.has_q, spec.cap, self.cfg.n_cells)
        return self._field(sim.packed, frame.start_grid, self.reuse_span_idx,
                           spec), overflow

    def _pack(self, field):
        lit = (field >= 1.0).reshape(self.rows, self.cols)
        return pack_framebuffer(lit, self.rows, self.cols)

    def render(self, sim):
        """(page-packed framebuffer, window overflow); callers fold the
        overflow into their stats (SimRunner adds it to neighbor_overflow)."""
        field, overflow = self.field(sim)
        return self._pack(field), overflow

    @tracer.traced("render.frame")
    def render_from_frame(self, sim, frame):
        """render() over the engine's frame (see field_from_frame)."""
        field, overflow = self.field_from_frame(sim, frame)
        return self._pack(field), overflow
