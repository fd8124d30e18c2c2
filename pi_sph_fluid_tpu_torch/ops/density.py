"""Masked kernel-weighted sums (port of
`pi_sph_fluid_tpu/ops/density.py:25-40`)."""

from __future__ import annotations

import torch

from ..config import SPHConfig
from ..core.kernels import kernel_w
from .neighbors import Candidates, pair_mask

__all__ = ["weighted_kernel_sum"]


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
