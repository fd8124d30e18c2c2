"""Artificial-pressure reference value (port of
`pi_sph_fluid_tpu/core/pair_terms.py:33-41`)."""

from __future__ import annotations

import numpy as np

from ..config import SPHConfig

__all__ = ["artificial_pressure_ref_w"]


def artificial_pressure_ref_w(cfg: SPHConfig) -> float:
    """W(q=0.2), the denominator of the Macklin artificial-pressure term
    (`pi_sph_fluid.c:325`: ``W(0.2*H, 0, 0, 0)``), in float32."""
    q = np.float32(cfg.q_artificial_pressure)
    tmp1 = np.float32(1.0) - np.float32(0.5) * q
    tmp2 = np.float32(1.0) + np.float32(2.0) * q
    return float(np.float32(cfg.kernel_norm) * tmp1**4 * tmp2)
