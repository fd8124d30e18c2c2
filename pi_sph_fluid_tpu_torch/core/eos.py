"""Tait (WCSPH) equation of state (port of `pi_sph_fluid_tpu/core/eos.py:18-26`).

`pi_sph_fluid.c:294-301`: p = B((rho/rho_0)^7 - 1), clamped at 0, with the
power taken by the same explicit multiplies in the same order.
"""

from __future__ import annotations

import torch

from ..config import SPHConfig
from .kernels import div_scalar

__all__ = ["tait_pressure"]


def tait_pressure(rho: torch.Tensor, cfg: SPHConfig) -> torch.Tensor:
    """Elementwise pressure from density; float32; negative clamped to 0."""
    ratio = div_scalar(rho, cfg.rho_0)
    r2 = ratio * ratio
    r4 = r2 * r2
    ratio7 = r4 * r2 * ratio
    p = cfg.tait_b * (ratio7 - 1.0)
    return torch.clamp_min(p, 0.0)
