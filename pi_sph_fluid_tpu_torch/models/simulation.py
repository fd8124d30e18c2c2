"""Per-tick statistics (port of `pi_sph_fluid_tpu/models/simulation.py:51-74`).

Only ``StepStats`` is ported so far; the jnp oracle stepper comes later.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["StepStats"]


class StepStats(NamedTuple):
    """Per-tick invariants (`pi_sph_fluid.c:656-675`).

    neighbor_overflow counts window lanes lost to the cap, plus x1e6 for
    every non-finite real row or L-budget overrun: it must read 0.
    stale (sticky modes only) counts real particles that drifted more than
    0.3*H since their group's layout was built."""

    max_rho_error_pct: torch.Tensor
    max_speed: torch.Tensor
    neighbor_overflow: torch.Tensor
    stale: torch.Tensor | None = None
