"""SPH density pass of the jnp oracle (port of
`pi_sph_fluid_tpu/ops/density.py:25-53`).

`calculate_density` (`pi_sph_fluid.c:263-289`) as masked reductions over
fixed-capacity candidate windows:

    rho_i = m_i W(0) + sum_{j in fluid} m_j W_ij + sum_{j in boundary} psi_j W_ij
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SPHConfig
from ..core.kernels import kernel_w, w_self
from .neighbors import Candidates, pair_mask

__all__ = ["weighted_kernel_sum", "density_pass"]


def weighted_kernel_sum(qx, qy, tx, ty, tw, cand: Candidates, cfg: SPHConfig,
                        exclude_self: bool) -> torch.Tensor:
    """sum_j tw_j * W_ij over each query's accepted candidates
    (`sph(ones, ..., MASS)`, `pi_sph_fluid.c:200-214`)."""
    idx = cand.idx.long()
    dx = qx[:, None] - tx[idx]
    dy = qy[:, None] - ty[idx]
    r = torch.sqrt(dx * dx + dy * dy)
    self_idx = (torch.arange(qx.shape[0], dtype=torch.int32, device=qx.device)
                if exclude_self else None)
    mask = pair_mask(r, cand.valid, cfg, self_idx=self_idx, cand_idx=cand.idx)
    w = tw[idx] * kernel_w(dx, dy, cfg)
    return torch.sum(torch.where(mask, w, torch.zeros_like(w)), dim=1)


def density_pass(fluid, boundary, cand_ff: Candidates, cand_fb: Candidates,
                 cfg: SPHConfig) -> torch.Tensor:
    """New fluid densities (`density.py:43-53`).  ``fluid`` is in grid-sorted
    order, so self-exclusion is slot == slot."""
    rho_self = fluid.m * float(np.float32(w_self(cfg)))
    rho_ff = weighted_kernel_sum(fluid.x, fluid.y, fluid.x, fluid.y, fluid.m,
                                 cand_ff, cfg, exclude_self=True)
    rho_fb = weighted_kernel_sum(fluid.x, fluid.y, boundary.x, boundary.y,
                                 boundary.m, cand_fb, cfg, exclude_self=False)
    return rho_self + rho_ff + rho_fb
