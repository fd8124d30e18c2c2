"""SPH acceleration pass of the jnp oracle (port of
`pi_sph_fluid_tpu/ops/forces.py:25-76`).

`calculate_accelerations` (`pi_sph_fluid.c:303-373`): per fluid particle, the
scalar pair term t_ij (core/pair_terms.py) summed through the SPH gradient
with the mass leading factor, over fluid and boundary neighbours apart:

    a_i = g - sum_{j in fluid} m_j t_ij grad_i W_ij
            - sum_{j in bdry} psi_j t^b_ij grad_i W_ij      (:370-371)
"""

from __future__ import annotations

import torch

from ..config import SPHConfig
from ..core.kernels import kernel_grad_w, kernel_w
from ..core.pair_terms import pair_term_fluid_boundary, pair_term_fluid_fluid
from .neighbors import Candidates, pair_mask

__all__ = ["acceleration_pass"]


def _pair_geometry(qx, qy, tx, ty, cand: Candidates):
    """(dx, dy, r) of every candidate lane, (Nq, lanes) each
    (`forces.py:25-31`)."""
    idx = cand.idx.long()
    dx = qx[:, None] - tx[idx]
    dy = qy[:, None] - ty[idx]
    return dx, dy, torch.sqrt(dx * dx + dy * dy)


def _masked_gradient_sum(coef, mask, dx, dy, cfg: SPHConfig):
    gwx, gwy = kernel_grad_w(dx, dy, cfg)
    coef = torch.where(mask, coef, torch.zeros_like(coef))
    return torch.sum(coef * gwx, dim=1), torch.sum(coef * gwy, dim=1)


def acceleration_pass(fluid, boundary, cand_ff: Candidates, cand_fb: Candidates,
                      gx: float, gy: float, cfg: SPHConfig):
    """(du_dt, dv_dt) for the grid-sorted fluid set (`forces.py:34-76`)."""
    slot = torch.arange(fluid.x.shape[0], dtype=torch.int32, device=fluid.x.device)

    # fluid-fluid (`pi_sph_fluid.c:314-340`)
    idx = cand_ff.idx.long()
    dx, dy, r = _pair_geometry(fluid.x, fluid.y, fluid.x, fluid.y, cand_ff)
    mask = pair_mask(r, cand_ff.valid, cfg, self_idx=slot, cand_idx=cand_ff.idx)
    t_ff = pair_term_fluid_fluid(
        dx, dy, fluid.u[:, None] - fluid.u[idx], fluid.v[:, None] - fluid.v[idx],
        fluid.p[:, None], fluid.rho[:, None], fluid.p[idx], fluid.rho[idx],
        kernel_w(dx, dy, cfg), cfg)
    ff_x, ff_y = _masked_gradient_sum(fluid.m[idx] * t_ff, mask, dx, dy, cfg)

    # fluid-boundary (`pi_sph_fluid.c:343-368`)
    idx = cand_fb.idx.long()
    dx, dy, r = _pair_geometry(fluid.x, fluid.y, boundary.x, boundary.y, cand_fb)
    mask = pair_mask(r, cand_fb.valid, cfg)
    t_fb = pair_term_fluid_boundary(
        dx, dy, fluid.u[:, None] - boundary.u[idx], fluid.v[:, None] - boundary.v[idx],
        fluid.p[:, None], fluid.rho[:, None], kernel_w(dx, dy, cfg), cfg)
    fb_x, fb_y = _masked_gradient_sum(boundary.m[idx] * t_fb, mask, dx, dy, cfg)

    return gx - ff_x - fb_x, gy - ff_y - fb_y
