"""Particle state of tensors (port of `pi_sph_fluid_tpu/state.py:21-101`).

Structure-of-arrays, one flat float32 tensor per field.  The npz checkpoint
format is the JAX package's (`state.py:64-101`): ``<name>.<field>`` keys,
so checkpoints written by either package load in the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["FluidState", "BoundaryState", "save_state", "load_state"]


class FluidState(NamedTuple):
    """Dynamic fluid particles.  All fields shape (N,), float32."""

    x: torch.Tensor
    y: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    m: torch.Tensor
    rho: torch.Tensor
    p: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[0]


class BoundaryState(NamedTuple):
    """Static Akinci boundary particles; ``m`` holds the pseudo-mass psi
    (`pi_sph_fluid.c:242-261`), ``rho`` is pinned at rho_0."""

    x: torch.Tensor
    y: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    m: torch.Tensor
    rho: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def permute(self, order: torch.Tensor) -> "BoundaryState":
        return BoundaryState(*(f[order] for f in self))


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_state(path: str, **trees) -> None:
    """Checkpoint named NamedTuples of tensors (or plain arrays) to .npz."""
    flat = {}
    for name, tree in trees.items():
        if hasattr(tree, "_fields"):
            for field, arr in zip(tree._fields, tree):
                flat[f"{name}.{field}"] = _np(arr)
        else:
            flat[name] = _np(tree)
    np.savez(path, **flat)


def load_state(path: str, device: torch.device | str) -> dict:
    """Load a checkpoint into {name: FluidState | BoundaryState | tensor}
    with every tensor on ``device``."""
    groups: dict = {}
    with np.load(path) as raw:
        for key in raw.files:
            arr = torch.as_tensor(raw[key], device=device)
            if "." in key:
                name, field = key.split(".", 1)
                groups.setdefault(name, {})[field] = arr
            else:
                groups[key] = arr
    out: dict = {}
    for name, val in groups.items():
        if isinstance(val, dict) and set(val) == set(FluidState._fields):
            out[name] = FluidState(**val)
        elif isinstance(val, dict) and set(val) == set(BoundaryState._fields):
            out[name] = BoundaryState(**val)
        else:
            out[name] = val
    return out
