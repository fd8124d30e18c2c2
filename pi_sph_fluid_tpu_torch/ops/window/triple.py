"""Row-triple merged candidate layout (port of
`pi_sph_fluid_tpu/ops/pallas/triple.py:79-428`, exact-start form).

The structure is the JAX package's, documented at `triple.py:1-58`:

* the query layout is row-padded, each grid row's capacity rounded up to
  ``qb``, so every block of ``qb`` consecutive queries lies in one row;
* grid rows are grouped ``seg_q`` at a time into candidate *segments*
  holding every fluid and boundary particle of rows [seg_q*s - 1,
  seg_q*(s+1)], ordered column-major, so a query block's candidates are
  one contiguous window: its segment's columns [c0 - 1, c1 + 1];
* lanes inside a window but outside the 3x3 stencil are >= one whole cell
  away, so the support clamp kills them: no per-lane masks.

Only the exact-start fetch (the JAX ``planes == 1`` branch,
`triple.py:402-407`) is ported: a CUDA load needs no 128-lane-aligned
start, so ``flen == w_len``.  The dual 64-shifted planes and the banded
gather are TPU workarounds and stay behind.

Every index the JAX code let XLA clamp is in range by construction here
(noted at each gather), and the two ``.at[].max(mode="drop")`` scatters
filter their indices to the valid range before ``scatter_reduce_``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...config import SPHConfig

__all__ = ["TripleSpec", "TripleCtx", "triple_spec", "build_frame",
           "block_windows", "INERT_X", "LANE"]

LANE = 128      # segment strides round to this, as in the JAX layout
INERT_X = -1e6  # inert slots sit far outside the domain -> q >= 2 kills them

_I32 = torch.int32


def _round_up(x, m):
    return -(-x // m) * m


class TripleSpec(NamedTuple):
    """Static shape parameters (host-side ints), `triple.py:79-114`."""

    tq: int          # queries per tile (the layout length is a multiple)
    qb: int          # queries per window block
    cap: int         # candidate lanes computed per block window
    seg_q: int       # query rows per candidate segment
    n_layout: int    # query-layout length (multiple of tq)
    L: int           # candidate-array length
    n_src: int       # gather-source rows: n_layout + nb + 1 (inert)
    n_runs: int      # run-table length

    @property
    def nqb(self) -> int:
        return self.tq // self.qb

    @property
    def n_tiles(self) -> int:
        return self.n_layout // self.tq


class TripleCtx(NamedTuple):
    """Per-relayout context (`triple.py:117-145`, unbanded).

    layout_src: (n_layout,) int32 row of the sorted + inert-extended source
                feeding each layout slot
    trip_src:   (L,) int32 gather-source row feeding each candidate slot
    w_start:    (n_tiles, nqb) int32 per-block window starts
    w_len:      (n_tiles, nqb) int32 window lengths
    flen:       (n_tiles, nqb) int32 fetch lengths (== w_len, exact start)
    T:          (n_cells+1, 8) int32 per-cell window table [wlo, whi, ...];
                T[n_cells, 2] carries the L-budget excess
    overflow:   () int32 window lanes beyond cap (+ x1e6 budget overrun)
    """

    layout_src: torch.Tensor
    trip_src: torch.Tensor
    w_start: torch.Tensor
    w_len: torch.Tensor
    flen: torch.Tensor
    T: torch.Tensor
    overflow: torch.Tensor


def triple_spec(cfg: SPHConfig, n_real: int, nb: int, tq: int = 256,
                qb: int = 16, cap: int = 256, seg_q: int = 3) -> TripleSpec:
    """Static sizes, the same formulas as `triple.py:170-214` (so every
    integer layout array can be compared with the JAX package's)."""
    assert tq % qb == 0 and cap > 0
    n_rows = cfg.n_cell_rows
    n_seg = -(-n_rows // seg_q)
    n_layout = _round_up(n_real + qb * n_rows, tq)
    cover = seg_q + 2
    copies = 3 if seg_q == 1 else 2
    L = _round_up(copies * (n_real + nb) + n_seg * (cap + 3 * LANE) + 2 * LANE, LANE)
    n_runs = n_seg * (cfg.n_cell_cols * cover * 2 + 1)
    return TripleSpec(tq=tq, qb=qb, cap=cap, seg_q=seg_q, n_layout=n_layout,
                      L=L, n_src=n_layout + nb + 1, n_runs=n_runs)


def _scatter_max_cummax(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``cummax(zeros(n).at[idx].max(vals, mode="drop"))``: out-of-range
    indices are dropped (filtered first; torch would raise)."""
    keep = (idx >= 0) & (idx < n)
    seed = torch.zeros(n, dtype=_I32, device=idx.device)
    seed.scatter_reduce_(0, idx[keep].long(), vals[keep], "amax")
    return torch.cummax(seed, 0).values


def _cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(a, dim, dtype=_I32)


def build_frame(spec: TripleSpec, cfg: SPHConfig, cell_starts: torch.Tensor,
                b_cell_starts: torch.Tensor):
    """Query layout and candidate construction from the CSRs alone
    (`triple.py:261-379`).  ``cell_starts`` (n_cells+2,) is the fluid CSR
    over sorted slots, ``b_cell_starts`` (n_cells+1,) the static boundary
    CSR.  Returns (layout_src, trip_src, T)."""
    dev = cell_starts.device
    m = cfg.n_cell_cols
    n_rows = cfg.n_cell_rows
    n_cells = cfg.n_cells
    qb, cap, seg_q = spec.qb, spec.cap, spec.seg_q
    n_seg = -(-n_rows // seg_q)
    cover = seg_q + 2
    ar = lambda n: torch.arange(n, dtype=_I32, device=dev)  # noqa: E731

    # ---- per-cell count grids ---------------------------------------------
    fcnt = (cell_starts[1:n_cells + 1] - cell_starts[:n_cells]).reshape(n_rows, m)
    bcnt = (b_cell_starts[1:n_cells + 1] - b_cell_starts[:n_cells]).reshape(n_rows, m)
    cnt_all = fcnt + bcnt
    row_count = torch.sum(fcnt, 1, dtype=_I32)
    row_start_sorted = cell_starts[:n_cells:m]              # cell_starts[r*m]

    # ---- query layout: per-row capacity rounded up to qb -------------------
    rowcap = _round_up(row_count, qb)
    rstart = torch.cat([torch.zeros(1, dtype=_I32, device=dev), _cumsum(rowcap, 0)])
    # trailing empty rows start at n_layout: dropped, not clamped
    row_of = _scatter_max_cummax(spec.n_layout, rstart[:n_rows], ar(n_rows)).long()
    k_row = ar(spec.n_layout) - rstart[row_of]              # row_of < n_rows
    layout_valid = k_row < row_count[row_of]
    layout_src = torch.where(
        layout_valid,
        torch.clamp_max(row_start_sorted[row_of] + k_row, spec.n_layout - 1),
        torch.full_like(k_row, spec.n_layout))

    # ---- candidate segments ------------------------------------------------
    P = torch.cat([torch.zeros((1, m), dtype=_I32, device=dev), _cumsum(cnt_all, 0)])
    s_ids = ar(n_seg)
    lo_row = torch.clamp_min(s_ids * seg_q - 1, 0).long()
    hi_row = torch.clamp_max((s_ids + 1) * seg_q, n_rows - 1).long()
    segcnt = P[hi_row + 1] - P[lo_row]                      # (n_seg, m)
    seg_len = torch.sum(segcnt, 1, dtype=_I32)
    seg_stride = ((seg_len + cap + 2 * LANE - 1) // LANE) * LANE
    seg_start = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                           _cumsum(seg_stride, 0)[:-1]])
    tcol_start = seg_start[:, None] + (_cumsum(segcnt, 1) - segcnt)

    # ---- per-cell window table T -------------------------------------------
    seg_of_row = (ar(n_rows) // seg_q).long()               # < n_seg
    tcs_r = tcol_start[seg_of_row]
    tce_r = tcs_r + segcnt[seg_of_row]
    wlo = torch.cat([tcs_r[:, :1], tcs_r[:, :-1]], 1)
    whi = torch.cat([tce_r[:, 1:], tce_r[:, -1:]], 1)
    T = torch.zeros((n_cells + 1, 8), dtype=_I32, device=dev)
    T[:n_cells, 0] = wlo.reshape(-1)
    T[:n_cells, 1] = whi.reshape(-1)
    # L-budget guard (`triple.py:330-338`): the excess rides in T[n_cells, 2]
    total_len = seg_start[-1] + seg_stride[-1]
    T[n_cells, 2] = torch.clamp_min(total_len - spec.L, 0)

    # ---- run table: trip_src via scatter-max + cummax + one gather ---------
    j_ids = torch.arange(cover * 2, device=dev)
    rt2 = lo_row[:, None] + (j_ids // 2)[None, :]           # (n_seg, cover*2)
    rt2_ok = rt2 <= hi_row[:, None]
    rt2_c = torch.clamp_max(rt2, n_rows - 1)
    is_b2 = ((j_ids % 2) == 1)[None, :, None]
    cs_grid = cell_starts[:n_cells].reshape(n_rows, m)
    bcs_grid = b_cell_starts[:n_cells].reshape(n_rows, m)
    lens3 = torch.where(rt2_ok[:, :, None],
                        torch.where(is_b2, bcnt[rt2_c], fcnt[rt2_c]),
                        torch.zeros((), dtype=_I32, device=dev))
    src0_f3 = (rstart[:n_rows][rt2_c] - row_start_sorted[rt2_c])[:, :, None] + cs_grid[rt2_c]
    src0_b3 = spec.n_layout + bcs_grid[rt2_c]
    src03 = torch.where(is_b2, src0_b3, src0_f3)
    lens = lens3.transpose(1, 2)                            # (n_seg, m, cover*2)
    src0 = src03.transpose(1, 2)
    pref = _cumsum(lens, 2) - lens
    slot0 = tcol_start[:, :, None] + pref
    far = torch.full_like(slot0, 1 << 29)                   # empty: inert via clamp
    delta = torch.where(lens > 0, src0 - slot0, far)
    pad_slot0 = (seg_start + seg_len)[:, None]
    pad_delta = torch.full((n_seg, 1), 1 << 29, dtype=_I32, device=dev)
    slot0 = torch.cat([slot0.reshape(n_seg, -1), pad_slot0], 1).reshape(-1)
    delta = torch.cat([delta.reshape(n_seg, -1), pad_delta], 1).reshape(-1)

    run_of = _scatter_max_cummax(spec.L, slot0, ar(spec.n_runs)).long()
    trip_src = torch.clamp_max(ar(spec.L) + delta[run_of], spec.n_src - 1)
    return layout_src, trip_src, T


def block_windows(spec: TripleSpec, cfg: SPHConfig, cells: torch.Tensor,
                  T: torch.Tensor):
    """Per-(tile, block) candidate windows from layout-order cell ids
    (`triple.py:382-428`, exact-start branch).  Returns (w_start, w_len,
    flen, overflow)."""
    n_cells = cfg.n_cells
    cells_b = cells.reshape(spec.n_tiles * spec.nqb, spec.qb)
    valid_b = cells_b < n_cells
    c_first = cells_b[:, 0]
    c_last = torch.amax(torch.where(valid_b, cells_b, torch.full_like(cells_b, -1)), 1)
    has_q = c_last >= 0
    none = torch.full_like(c_first, n_cells)
    T_lo = T[torch.where(has_q, c_first, none).long()]      # cells <= n_cells
    T_hi = T[torch.where(has_q, c_last, none).long()]
    zero = torch.zeros_like(c_first)
    w_start = torch.where(has_q, T_lo[:, 0], zero)
    w_len = torch.where(has_q, T_hi[:, 1] - T_lo[:, 0], zero)
    flen = w_len
    # saturating sum in f32, as `triple.py:418-423`: an int32 sum could wrap
    raw = torch.sum(torch.clamp_min(flen - spec.cap, 0).to(torch.float32))
    overflow = torch.clamp_max(raw, 1e8).to(_I32)
    overflow = overflow + torch.clamp_max(T[n_cells, 2], 1000) * 1_000_000
    shape = (spec.n_tiles, spec.nqb)
    return (w_start.reshape(shape), w_len.reshape(shape), flen.reshape(shape),
            overflow)
