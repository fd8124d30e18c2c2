"""Wendland C2 smoothing kernel and its gradient (port of
`pi_sph_fluid_tpu/core/kernels.py:28-78`).

Mirrors `pi_sph_fluid.c:45-50` with the explicit compact-support clamp a
vectorised evaluation needs.  Float32 throughout, same operation order as
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SPHConfig

__all__ = ["kernel_w", "kernel_w_scalar", "kernel_grad_w", "w_self", "w_at_q",
           "div_scalar"]


def div_scalar(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` as a true float32 division.  torch turns division by a
    scalar into multiplication by its reciprocal, which can round
    differently from the JAX package's division."""
    return a / a.new_full((1,), s)


def w_at_q(q: torch.Tensor, cfg: SPHConfig) -> torch.Tensor:
    """W(q) = 7/(4 pi H^2) (1 - q/2)^4 (1 + 2q) for q < 2, else 0."""
    tmp_1 = 1.0 - 0.5 * q
    tmp_2 = 1.0 + 2.0 * q
    w = cfg.kernel_norm * (tmp_1 * tmp_1) * (tmp_1 * tmp_1) * tmp_2
    return torch.where(q < 2.0, w, torch.zeros_like(w))


def kernel_w_scalar(r: torch.Tensor, cfg: SPHConfig) -> torch.Tensor:
    """W as a function of the pair distance r (elementwise)."""
    return w_at_q(div_scalar(r, cfg.h), cfg)


def kernel_w(dx: torch.Tensor, dy: torch.Tensor, cfg: SPHConfig) -> torch.Tensor:
    """W from coordinate differences dx = x_i - x_j, dy = y_i - y_j."""
    return kernel_w_scalar(torch.sqrt(dx * dx + dy * dy), cfg)


def w_self(cfg: SPHConfig) -> float:
    """W(0) = the normalisation, the density self-term factor
    (`pi_sph_fluid.c:274`)."""
    return cfg.kernel_norm


def kernel_grad_w(dx: torch.Tensor, dy: torch.Tensor, cfg: SPHConfig):
    """grad_i W as (gx, gy) (`kernels.py:58-78`): norm (-5) (1 - q/2)^3 / H^2
    times (dx, dy), which never divides by r and is 0 at r = 0; 0 outside
    the support q >= 2 (`pi_sph_fluid.c:56-61`)."""
    h = np.float32(cfg.h)
    q = div_scalar(torch.sqrt(dx * dx + dy * dy), float(h))
    tmp = 1.0 - 0.5 * q
    coeff = float(np.float32(cfg.kernel_norm) * np.float32(-5.0)) * (tmp * tmp * tmp)
    coeff = div_scalar(coeff, float(h * h))
    coeff = torch.where(q < 2.0, coeff, torch.zeros_like(coeff))
    return coeff * dx, coeff * dy
