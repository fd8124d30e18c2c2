"""Candidate gathering, capacity overflow and pair masks (port of
`pi_sph_fluid_tpu/ops/neighbors.py:24-74`).

They serve the boundary pseudo-mass precompute, the oracle renderer and the
jnp-oracle stepper (models/simulation.py): a fixed-capacity window per row
span with a validity mask, the dropped candidates counted by
``span_overflow`` (0 == exact physics), and the brute-force all-pairs mask
that validates them (`README.md:110`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SPHConfig
from .grid import GridContext, row_spans

__all__ = ["Candidates", "gather_candidates", "span_overflow", "pair_mask",
           "brute_force_neighbor_mask"]


class Candidates(NamedTuple):
    """Fixed-capacity candidate window per query: sorted-array slots
    (clamped) and span membership, each (Nq, 3*cap)."""

    idx: torch.Tensor
    valid: torch.Tensor


def gather_candidates(qx, qy, grid: GridContext, cfg: SPHConfig,
                      cap: int | None = None) -> Candidates:
    """Candidate slots for each query from its 3 row spans."""
    cap = cfg.row_span_cap if cap is None else cap
    starts, ends = row_spans(qx, qy, grid, cfg)
    lane = torch.arange(cap, dtype=torch.int32, device=qx.device)
    idx = starts[:, :, None] + lane[None, None, :]
    valid = idx < ends[:, :, None]
    idx = torch.clamp_max(idx, grid.order.shape[0] - 1)
    nq = idx.shape[0]
    return Candidates(idx=idx.reshape(nq, -1), valid=valid.reshape(nq, -1))


def span_overflow(qx, qy, grid: GridContext, cfg: SPHConfig,
                  cap: int | None = None) -> torch.Tensor:
    """Candidates dropped by the fixed capacity, an int32 scalar
    (`neighbors.py:48-52`)."""
    cap = cfg.row_span_cap if cap is None else cap
    starts, ends = row_spans(qx, qy, grid, cfg)
    return torch.sum(torch.clamp_min(ends - starts - cap, 0), dtype=torch.int32)


def pair_mask(r, valid, cfg: SPHConfig, self_idx=None, cand_idx=None):
    """The reference's acceptance test (`pi_sph_fluid.c:144`): distance
    strictly < 2H, lane valid, and (same-set queries) not self."""
    mask = valid & (r < cfg.support_radius)
    if self_idx is not None:
        mask = mask & (cand_idx != self_idx[:, None])
    return mask


def brute_force_neighbor_mask(qx, qy, tx, ty, cfg: SPHConfig,
                              exclude_self: bool) -> torch.Tensor:
    """O(Nq*Nt) all-pairs acceptance mask, the validation oracle
    (`neighbors.py:64-74`)."""
    dx = qx[:, None] - tx[None, :]
    dy = qy[:, None] - ty[None, :]
    mask = torch.sqrt(dx * dx + dy * dy) < cfg.support_radius
    if exclude_self:
        mask = mask & ~torch.eye(qx.shape[0], tx.shape[0], dtype=torch.bool,
                                 device=qx.device)
    return mask
