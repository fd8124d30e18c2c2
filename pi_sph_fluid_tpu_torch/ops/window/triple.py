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

The physics kernels do not read the gathered candidate array at all.  The
sort is row-major and the query layout keeps every grid row contiguous and
column-sorted, so the lanes of a block's window are, grid row by grid row
of its segment, one contiguous run of layout-order fluid rows and one
contiguous run of the static boundary rows: ``block_spans`` returns these
``2 * (seg_q + 2)`` [start, len] spans per block, the same lanes as the
window in row-major instead of column-major order, and the kernels read
them straight from the state.  The renderer's field kernel reads the fluid
half of the same spans for its pixel blocks, resolving them itself from the
relayout's per-cell start grid (``start_grid``) through static per-block
index pairs (``span_index``): the engine hands it a ``Frame``.  So the JAX
layout's gather map of the (L, k) candidate array (``trip_src``, its run
table, an (L,) scatter-max and cummax) is not built at all; L only sizes
the budget guard of ``T``.

Every index the JAX code let XLA clamp is in range by construction here
(noted at each gather), and the two ``.at[].max(mode="drop")`` scatters
filter their indices to the valid range before ``scatter_reduce_``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ...config import SPHConfig

__all__ = ["TripleSpec", "TripleCtx", "Frame", "triple_spec", "build_frame",
           "block_windows", "block_spans", "span_index", "start_grid",
           "INERT_X", "LANE"]

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
    L: int           # candidate-lane budget (the JAX candidate array's length)

    @property
    def nqb(self) -> int:
        return self.tq // self.qb

    @property
    def n_tiles(self) -> int:
        return self.n_layout // self.tq

    @property
    def n_spans(self) -> int:
        """Spans per block: a fluid and a boundary run for each grid row of
        a segment (seg_q query rows and one row of cover on either side)."""
        return 2 * (self.seg_q + 2)


class TripleCtx(NamedTuple):
    """Per-relayout context (`triple.py:117-145`, unbanded).

    layout_src: (n_layout,) int32 row of the sorted + inert-extended source
                feeding each layout slot
    start_grid: (n_rows * (m + 1),) int32 layout row at which each fluid
                cell starts (``start_grid``), the renderer's frame input
    w_start:    (n_tiles, nqb) int32 per-block window starts
    w_len:      (n_tiles, nqb) int32 window lengths
    flen:       (n_tiles, nqb) int32 fetch lengths (== w_len, exact start)
    T:          (n_cells+1, 8) int32 per-cell window table [wlo, whi, ...];
                T[n_cells, 2] carries the L-budget excess
    overflow:   () int32 window lanes beyond cap (+ x1e6 budget overrun)
    spans:      (n_tiles * nqb, n_spans, 2) int32 per-block [start, len]: the
                window's lanes as contiguous runs, first one per segment row
                of layout-order fluid rows, then one per segment row of
                boundary rows; sum(len) == w_len
    """

    layout_src: torch.Tensor
    start_grid: torch.Tensor
    w_start: torch.Tensor
    w_len: torch.Tensor
    flen: torch.Tensor
    T: torch.Tensor
    overflow: torch.Tensor
    spans: torch.Tensor


class Frame(NamedTuple):
    """What a renderer needs of a relayout to draw from the packed state
    without a sort of its own (``make_multi_step(return_frame=True)``).

    start_grid: (n_rows * (m + 1),) int32, ``start_grid`` of the relayout:
                entry r * (m + 1) + c is the row of the packed state at which
                fluid cell (r, c) starts, entry r * (m + 1) + m the end of
                grid row r.  Rows of whatever array the renderer is given,
                so a part of a domain can hand over its own.
    T:          (n_cells+1, 8) int32, ``TripleCtx.T``: the pixel windows'
                lengths (fluid and boundary lanes) for the overflow count
    """

    start_grid: torch.Tensor
    T: torch.Tensor


def triple_spec(cfg: SPHConfig, n_real: int, nb: int, tq: int = 256,
                qb: int = 16, cap: int = 256, seg_q: int = 3) -> TripleSpec:
    """Static sizes, the same formulas as `triple.py:170-214` (so every
    integer layout array can be compared with the JAX package's)."""
    assert tq % qb == 0 and cap > 0
    n_rows = cfg.n_cell_rows
    n_seg = -(-n_rows // seg_q)
    n_layout = _round_up(n_real + qb * n_rows, tq)
    copies = 3 if seg_q == 1 else 2
    L = _round_up(copies * (n_real + nb) + n_seg * (cap + 3 * LANE) + 2 * LANE, LANE)
    return TripleSpec(tq=tq, qb=qb, cap=cap, seg_q=seg_q, n_layout=n_layout, L=L)


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
    """Query layout and per-cell window table from the CSRs alone
    (`triple.py:261-338`; the run table and the gather map that follow
    there are not built).  ``cell_starts`` (n_cells+2,) is the fluid CSR
    over sorted slots, ``b_cell_starts`` (n_cells+1,) the static boundary
    CSR.  Returns (layout_src, T, row_shift); ``row_shift`` (n_rows,) int32
    is, per grid row, the layout slot less the sorted slot of the row's
    first particle, which ``start_grid`` needs."""
    dev = cell_starts.device
    m = cfg.n_cell_cols
    n_rows = cfg.n_cell_rows
    n_cells = cfg.n_cells
    cap, seg_q = spec.cap, spec.seg_q
    n_seg = -(-n_rows // seg_q)
    ar = lambda n: torch.arange(n, dtype=_I32, device=dev)  # noqa: E731

    # ---- per-cell count grids ---------------------------------------------
    fcnt = (cell_starts[1:n_cells + 1] - cell_starts[:n_cells]).reshape(n_rows, m)
    bcnt = (b_cell_starts[1:n_cells + 1] - b_cell_starts[:n_cells]).reshape(n_rows, m)
    cnt_all = fcnt + bcnt
    row_count = torch.sum(fcnt, 1, dtype=_I32)
    row_start_sorted = cell_starts[:n_cells:m]              # cell_starts[r*m]

    # ---- query layout: per-row capacity rounded up to qb -------------------
    rowcap = _round_up(row_count, spec.qb)
    rstart = torch.cat([torch.zeros(1, dtype=_I32, device=dev), _cumsum(rowcap, 0)])
    row_shift = rstart[:n_rows] - row_start_sorted
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
    return layout_src, T, row_shift


def _block_cells(spec: TripleSpec, cfg: SPHConfig, cells: torch.Tensor):
    """(c_first, c_last, has_q) per block of qb layout queries: its first
    and its last valid cell id (a block lies in one grid row and its valid
    queries come first), and whether it holds any query at all."""
    cells_b = cells.reshape(spec.n_tiles * spec.nqb, spec.qb)
    valid_b = cells_b < cfg.n_cells
    c_first = cells_b[:, 0]
    c_last = torch.amax(torch.where(valid_b, cells_b, torch.full_like(cells_b, -1)), 1)
    return c_first, c_last, c_last >= 0


def block_windows(spec: TripleSpec, cfg: SPHConfig, cells: torch.Tensor,
                  T: torch.Tensor):
    """Per-(tile, block) candidate windows from layout-order cell ids
    (`triple.py:382-428`, exact-start branch).  Returns (w_start, w_len,
    flen, overflow)."""
    n_cells = cfg.n_cells
    c_first, c_last, has_q = _block_cells(spec, cfg, cells)
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


@functools.lru_cache(maxsize=8)
def _span_tables(cfg: SPHConfig, seg_q: int, device: torch.device):
    """Static per-cell tables of ``span_index`` for a block whose first
    valid query lies in cell c (row r = c // m) and whose last in cell c':
    ``i_lo[c]`` / ``i_hi[c']`` (n_cells + 1, cover) index, for each grid row
    rr of r's segment, the entries (rr, c_lo) and (rr, c_hi + 1) of an
    (n_rows, m + 1) start grid, c_lo = max(col - 1, 0), c_hi + 1 =
    min(col' + 2, m); ``ok[c]`` (n_cells + 1, cover) says whether rr is a
    row of the segment.  Entry n_cells (a block without queries) is all 0."""
    m, n_rows, n_cells = cfg.n_cell_cols, cfg.n_cell_rows, cfg.n_cells
    cover = seg_q + 2
    c = torch.arange(n_cells, dtype=_I32, device=device)
    row, col = c // m, c % m
    base = row // seg_q * seg_q
    rr = torch.clamp_min(base - 1, 0)[:, None] + torch.arange(
        cover, dtype=_I32, device=device)[None, :]
    ok = rr <= torch.clamp_max(base + seg_q, n_rows - 1)[:, None]
    at = torch.clamp_max(rr, n_rows - 1) * (m + 1)
    i_lo = at + torch.clamp_min(col - 1, 0)[:, None]
    i_hi = at + torch.clamp_max(col + 2, m)[:, None]
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:1])])  # noqa: E731
    return pad(i_lo), pad(i_hi), pad(ok)


def span_index(cfg: SPHConfig, seg_q: int, c_first: torch.Tensor,
               c_last: torch.Tensor, has_q: torch.Tensor) -> torch.Tensor:
    """(blocks, cover, 2) int32 [i_lo, i_hi], cover = seg_q + 2: where, in a
    start grid (``start_grid``), each span of a block begins and ends.  The
    block's queries lie in one grid row, the first valid one in cell
    ``c_first`` and the last in ``c_last`` (``has_q`` false: no query, and
    the cells are ignored).  Its window is the columns [c_first - 1,
    c_last + 1] (clamped to the grid) over every grid row rr of its
    segment, so for a grid g span k is rows [g[i_lo[k]], g[i_hi[k]]).  A
    span past the segment's last row, and every span of a block without
    queries, has i_hi = i_lo: length 0.  Static wherever the blocks' cells
    are (the renderer's pixel blocks); the engine's follow its relayout."""
    i_lo, i_hi, ok = _span_tables(cfg, seg_q, c_first.device)
    none = torch.full_like(c_first, cfg.n_cells)
    first = torch.where(has_q, c_first, none)
    lo = i_lo[first]                                        # (blocks, cover)
    hi = torch.where(ok[first], i_hi[torch.where(has_q, c_last, none)], lo)
    return torch.stack([lo, hi], 2)


def start_grid(cfg: SPHConfig, cell_starts: torch.Tensor,
               row_shift: torch.Tensor | None = None) -> torch.Tensor:
    """(n_rows * (m + 1),) int32 view of a CSR over cells as per-row starts:
    entry r * (m + 1) + c is the start of cell (r, c), entry r * (m + 1) + m
    the end of grid row r; ``cell_starts`` must reach index n_cells.  With
    ``row_shift`` (``build_frame``'s) the fluid CSR over sorted slots turns
    into rows of the query layout, where grid row r is contiguous and
    column-sorted: cell (r, c) starts at layout row
    ``row_shift[r] + cell_starts[r * m + c]``."""
    m, n_rows = cfg.n_cell_cols, cfg.n_cell_rows
    grid = cell_starts.as_strided((n_rows, m + 1), (m, 1))
    if row_shift is not None:
        grid = row_shift[:, None] + grid
    return grid.reshape(-1)


def block_spans(spec: TripleSpec, cfg: SPHConfig, cells: torch.Tensor,
                f_grid: torch.Tensor, b_grid: torch.Tensor) -> torch.Tensor:
    """Per-block span table (n_tiles * nqb, n_spans, 2) int32 [start, len]:
    the lanes of the block's window (``block_windows``) as contiguous runs
    of the arrays they come from, so that no candidate array has to be
    gathered.  ``cells`` are the layout-order cell ids, ``f_grid`` the
    relayout's fluid start grid (``start_grid`` with ``build_frame``'s
    row_shift) and ``b_grid`` the boundary CSR's (static).

    Per segment row rr (``span_index``) the lanes are

    * spans [0, cover):        layout rows [f(rr, c_lo), f(rr, c_hi + 1)),
    * spans [cover, 2*cover):  boundary rows
                               [b_cell_starts[rr*m + c_lo],
                                b_cell_starts[rr*m + c_hi + 1]),

    with cover = seg_q + 2.  The lengths sum to ``w_len`` and the rows are
    those of the JAX layout's ``trip_src[w_start : w_start + w_len]``, in
    row-major instead of column-major order."""
    idx = span_index(cfg, spec.seg_q, *_block_cells(spec, cfg, cells))
    lo, hi = idx[:, :, 0], idx[:, :, 1]
    start = torch.cat([f_grid[lo], b_grid[lo]], 1)
    end = torch.cat([f_grid[hi], b_grid[hi]], 1)
    return torch.stack([start, end - start], 2)
