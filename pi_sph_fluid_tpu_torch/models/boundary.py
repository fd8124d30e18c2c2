"""Akinci boundary pseudo-mass precompute (port of
`pi_sph_fluid_tpu/models/boundary.py:27-47`).

psi_i = rho_i / sum_{j != i, r_ij < 2H} W_ij over boundary neighbours
(`pi_sph_fluid.c:242-261`).  The sum excludes the self term, as the
reference's same-set neighbour query does (`boundary.py:3-7`).
"""

from __future__ import annotations

import torch

from ..config import SPHConfig
from ..ops.density import weighted_kernel_sum
from ..ops.grid import GridContext, build_grid
from ..ops.neighbors import gather_candidates
from ..state import BoundaryState

__all__ = ["prepare_boundary"]


def prepare_boundary(boundary: BoundaryState,
                     cfg: SPHConfig) -> tuple[BoundaryState, GridContext]:
    """Sort the boundary into grid order and fill in pseudo-masses.
    Returns the grid-sorted BoundaryState (``m`` = psi) and its GridContext,
    whose ``cell_starts`` the engine reuses every step."""
    grid = build_grid(boundary.x, boundary.y, cfg)
    bs = boundary.permute(grid.order.long())
    cand = gather_candidates(bs.x, bs.y, grid, cfg)
    recip_volume = weighted_kernel_sum(bs.x, bs.y, bs.x, bs.y,
                                       torch.ones_like(bs.x), cand, cfg,
                                       exclude_self=True)
    return bs._replace(m=bs.rho / recip_volume), grid
