"""Generic SPH interpolation operators (port of
`pi_sph_fluid_tpu/ops/sph_operators.py:28-71`).

The reference's two sums with a selectable leading factor (`enum
leading_factor {MASS, VOLUME}`, `pi_sph_fluid.c:198-231`):

    sph:           A_i = sum_j f_j w_j W_ij
    sph_gradient:  grad A_i = sum_j f_j w_j grad_i W_ij

with w_j = m_j (MASS) or m_j / rho_j (VOLUME, defined but never called in
the reference; kept for the same API).  The physics passes are fused
specialisations of these.
"""

from __future__ import annotations

import torch

from ..config import SPHConfig
from ..core.kernels import kernel_grad_w, kernel_w
from .neighbors import Candidates, pair_mask

__all__ = ["sph_interpolate", "sph_gradient"]


def _leading(m_j, rho_j, leading_factor: str):
    if leading_factor == "mass":
        return m_j
    if leading_factor == "volume":
        return m_j / rho_j
    raise ValueError(f"leading_factor must be 'mass' or 'volume', got {leading_factor!r}")


def _lanes(qx, qy, tx, ty, tm, trho, cand: Candidates, cfg: SPHConfig,
           leading_factor: str, exclude_self: bool):
    """(idx, leading factor, dx, dy, acceptance mask) of every lane."""
    idx = cand.idx.long()
    w_j = _leading(tm[idx], trho[idx], leading_factor)
    dx = qx[:, None] - tx[idx]
    dy = qy[:, None] - ty[idx]
    r = torch.sqrt(dx * dx + dy * dy)
    self_idx = (torch.arange(qx.shape[0], dtype=torch.int32, device=qx.device)
                if exclude_self else None)
    return idx, w_j, dx, dy, pair_mask(r, cand.valid, cfg, self_idx=self_idx,
                                       cand_idx=cand.idx)


def sph_interpolate(quantity, qx, qy, tx, ty, tm, trho, cand: Candidates,
                    cfg: SPHConfig, leading_factor: str = "mass",
                    exclude_self: bool = False) -> torch.Tensor:
    """A_i = sum_j quantity_j leading_j W_ij over accepted candidates;
    targets in grid-sorted order, queries any point set."""
    idx, w_j, dx, dy, mask = _lanes(qx, qy, tx, ty, tm, trho, cand, cfg,
                                    leading_factor, exclude_self)
    term = quantity[idx] * w_j * kernel_w(dx, dy, cfg)
    return torch.sum(torch.where(mask, term, torch.zeros_like(term)), dim=1)


def sph_gradient(quantity, qx, qy, tx, ty, tm, trho, cand: Candidates,
                 cfg: SPHConfig, leading_factor: str = "mass",
                 exclude_self: bool = False):
    """grad A_i = sum_j quantity_j leading_j grad_i W_ij as (gx, gy).
    ``quantity`` is per lane (the shape of cand.idx, e.g. a pair term) or
    per target (gathered through cand.idx)."""
    idx, w_j, dx, dy, mask = _lanes(qx, qy, tx, ty, tm, trho, cand, cfg,
                                    leading_factor, exclude_self)
    q = quantity if quantity.shape == cand.idx.shape else quantity[idx]
    gwx, gwy = kernel_grad_w(dx, dy, cfg)
    coef = q * w_j
    coef = torch.where(mask, coef, torch.zeros_like(coef))
    return torch.sum(coef * gwx, dim=1), torch.sum(coef * gwy, dim=1)
