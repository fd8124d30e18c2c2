"""Per-pair scalar terms of the WCSPH momentum equation (port of
`pi_sph_fluid_tpu/core/pair_terms.py:33-93`).

For every neighbour pair, t_ij = pressure + Macklin artificial pressure +
Monaghan viscosity (`pi_sph_fluid.c:317-365`); the fluid-boundary variant
drops the wall's pressure and divides the viscosity by rho_i alone
(`pi_sph_fluid.c:350,362`).  Elementwise float32, the JAX package's
operation order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SPHConfig
from .kernels import div_scalar

__all__ = ["artificial_pressure_ref_w", "pair_term_fluid_fluid",
           "pair_term_fluid_boundary"]


def artificial_pressure_ref_w(cfg: SPHConfig) -> float:
    """W(q=0.2), the denominator of the Macklin artificial-pressure term
    (`pi_sph_fluid.c:325`: ``W(0.2*H, 0, 0, 0)``), in float32."""
    q = np.float32(cfg.q_artificial_pressure)
    tmp1 = np.float32(1.0) - np.float32(0.5) * q
    tmp2 = np.float32(1.0) + np.float32(2.0) * q
    return float(np.float32(cfg.kernel_norm) * tmp1**4 * tmp2)


def _artificial_pressure(w_ij, cfg: SPHConfig):
    """k (W_ij / W(0.2H))^4 (`pi_sph_fluid.c:325`)."""
    ratio = div_scalar(w_ij, artificial_pressure_ref_w(cfg))
    r2 = ratio * ratio
    return float(np.float32(cfg.k_artificial_pressure)) * (r2 * r2)


def _viscosity_mu(dx, dy, du, dv, cfg: SPHConfig):
    """Monaghan mu_ij and the approach gate (`pi_sph_fluid.c:328-334`)."""
    xy_dot_uv = dx * du + dy * dv
    xy_dot_xy = dx * dx + dy * dy
    h = np.float32(cfg.h)
    mu = float(h) * xy_dot_uv / (xy_dot_xy + float(np.float32(cfg.eps_visc) * h * h))
    return mu, xy_dot_uv < 0.0


def _visc_coef(cfg: SPHConfig) -> float:
    """-alpha c in float32."""
    return float(-np.float32(cfg.alpha_visc) * np.float32(cfg.c))


def pair_term_fluid_fluid(dx, dy, du, dv, p_i, rho_i, p_j, rho_j, w_ij,
                          cfg: SPHConfig):
    """t_ij for a fluid-fluid pair (`pi_sph_fluid.c:317-337`); dx, dy, du,
    dv are (i - j) differences, w_ij the kernel value."""
    pressure = p_i / (rho_i * rho_i) + p_j / (rho_j * rho_j)
    artif = _artificial_pressure(w_ij, cfg)
    mu, approaching = _viscosity_mu(dx, dy, du, dv, cfg)
    mean_rho = (rho_i + rho_j) * 0.5
    visc = _visc_coef(cfg) * mu / mean_rho
    return pressure + artif + torch.where(approaching, visc, torch.zeros_like(visc))


def pair_term_fluid_boundary(dx, dy, du, dv, p_i, rho_i, w_ij, cfg: SPHConfig):
    """t_ij for a fluid-boundary pair (`pi_sph_fluid.c:346-365`): no wall
    pressure, viscosity over rho_i alone."""
    pressure = p_i / (rho_i * rho_i)
    artif = _artificial_pressure(w_ij, cfg)
    mu, approaching = _viscosity_mu(dx, dy, du, dv, cfg)
    visc = _visc_coef(cfg) * mu / rho_i
    return pressure + artif + torch.where(approaching, visc, torch.zeros_like(visc))
