"""Wendland C2 smoothing kernel (port of `pi_sph_fluid_tpu/core/kernels.py:28-55`).

Mirrors `pi_sph_fluid.c:45-50` with the explicit compact-support clamp a
vectorised evaluation needs.  Float32 throughout, same operation order as
the JAX package.
"""

from __future__ import annotations

import torch

from ..config import SPHConfig

__all__ = ["kernel_w", "kernel_w_scalar", "w_self", "w_at_q", "div_scalar"]


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
