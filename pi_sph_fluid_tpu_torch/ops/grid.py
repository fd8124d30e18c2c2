"""Counting-sort uniform hash grid (port of `pi_sph_fluid_tpu/ops/grid.py:32-108`).

Cell ids are row-major over the 2H x 2H grid (`pi_sph_fluid.c:104-124`);
a stable sort by cell id plus a histogram + cumsum gives CSR cell offsets.
``cell_ids`` is bitwise equal to the JAX package's: the inverse cell
length is one float32 division and the floor runs in float32
(`grid.py:55-58`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SPHConfig

__all__ = ["GridContext", "inv_cell_length", "cell_coords", "cell_ids", "build_grid",
           "row_spans"]


class GridContext(NamedTuple):
    """Sorted-grid view of one particle set.

    order:        (N,) int32 original index of each sorted slot
    sorted_cells: (N,) int32 cell id per sorted slot (non-decreasing)
    cell_starts:  (n_cells+1,) int32 CSR offsets
    """

    order: torch.Tensor
    sorted_cells: torch.Tensor
    cell_starts: torch.Tensor


def _floor_index(a: torch.Tensor, inv: float, n: int) -> torch.Tensor:
    # clamp in float first: a float -> int cast of an out-of-range value is
    # implementation-defined in torch, where XLA saturates (NaN -> 0)
    f = torch.clamp(torch.floor(a * inv), -1.0, float(n))
    return torch.clamp(f.to(torch.int32), 0, n - 1)


def inv_cell_length(cfg: SPHConfig) -> float:
    """The inverse cell length, one float32 division (`grid.py:55-58`)."""
    return float(np.float32(1.0) / np.float32(cfg.cell_length))


def cell_coords(x: torch.Tensor, y: torch.Tensor, cfg: SPHConfig):
    """(row, col) int32 cell coordinates, clamped into the grid."""
    inv = inv_cell_length(cfg)
    return (_floor_index(y, inv, cfg.n_cell_rows),
            _floor_index(x, inv, cfg.n_cell_cols))


def cell_ids(x: torch.Tensor, y: torch.Tensor, cfg: SPHConfig) -> torch.Tensor:
    """Row-major cell id, `ij_cell = i_cell * m_cells + j_cell`
    (`pi_sph_fluid.c:113`)."""
    ci, cj = cell_coords(x, y, cfg)
    return ci * cfg.n_cell_cols + cj


def csr_starts(keys: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Inclusive cumsum of a histogram of ``keys + 1`` over ``n_bins`` bins:
    int32 CSR offsets with a leading 0 (`.at[keys+1].add(1)` + cumsum)."""
    counts = torch.bincount(keys.long() + 1, minlength=n_bins)[:n_bins]
    return torch.cumsum(counts, 0, dtype=torch.int32)


def build_grid(x: torch.Tensor, y: torch.Tensor, cfg: SPHConfig) -> GridContext:
    """Counting-sort the particle set by cell id (stable, deterministic)."""
    ids = cell_ids(x, y, cfg)
    order = torch.argsort(ids, stable=True).to(torch.int32)
    return GridContext(order=order, sorted_cells=ids[order.long()],
                       cell_starts=csr_starts(ids, cfg.n_cells + 1))


def row_spans(qx: torch.Tensor, qy: torch.Tensor, grid: GridContext,
              cfg: SPHConfig):
    """Per query, the 3 contiguous sorted-array spans of its 3x3 stencil
    (`pi_sph_fluid.c:136-141`).  Returns (starts, ends), (Nq, 3) int32."""
    ci, cj = cell_coords(qx, qy, cfg)
    m = cfg.n_cell_cols
    col_lo = torch.clamp_min(cj - 1, 0)
    col_hi = torch.clamp_max(cj + 1, m - 1)
    rows = ci[:, None] + torch.tensor([-1, 0, 1], dtype=torch.int32,
                                      device=qx.device)[None, :]
    row_ok = (rows >= 0) & (rows < cfg.n_cell_rows)
    rows_c = torch.clamp(rows, 0, cfg.n_cell_rows - 1)
    first_cell = rows_c * m + col_lo[:, None]
    last_cell = rows_c * m + col_hi[:, None]
    starts = grid.cell_starts[first_cell.long()]
    ends = grid.cell_starts[(last_cell + 1).long()]
    zero = torch.zeros_like(starts)
    return torch.where(row_ok, starts, zero), torch.where(row_ok, ends, zero)
