"""Scene builders (port of `pi_sph_fluid_tpu/models/scene.py:35-151`).

The reference accumulates lattice coordinates in a C ``float``
(`pi_sph_fluid.c:475-540`); the lattices are built here in numpy float32
exactly as the JAX package builds them, then moved to ``device``, so the
two packages' scenes are bitwise identical.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import SPHConfig
from ..state import BoundaryState, FluidState

__all__ = [
    "float32_lattice",
    "in_circle_drop",
    "build_fluid",
    "build_box_boundary",
    "build_drop_scene",
    "build_dam_break_scene",
    "build_pool_scene",
    "pixel_centers",
]


def float32_lattice(stop: float, step: float) -> np.ndarray:
    """Values of ``for(float a = 0; a < stop; a += step)`` in float32."""
    out = []
    a = np.float32(0.0)
    stop32 = np.float32(stop)
    step32 = np.float32(step)
    while a < stop32:
        out.append(a)
        a = np.float32(a + step32)
    return np.asarray(out, np.float32)


def in_circle_drop(cfg: SPHConfig) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """The reference's initial shape: a circle of radius 0.70 m centred
    mid-domain (`pi_sph_fluid.c:238-240`)."""
    cx = np.float32(cfg.width) / np.float32(2.0)
    cy = np.float32(cfg.height) / np.float32(2.0)

    def predicate(x: np.ndarray, y: np.ndarray) -> np.ndarray:
        dx = np.float32(x) - cx
        dy = np.float32(y) - cy
        dist = np.sqrt((dx * dx + dy * dy).astype(np.float32), dtype=np.float32)
        return dist < 0.70  # double literal compare, as in C

    return predicate


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)


def build_fluid(cfg: SPHConfig, predicate: Callable, device) -> FluidState:
    """Stipple the domain lattice and keep points satisfying ``predicate``
    (`pi_sph_fluid.c:484-506`); outer x, inner y, as in C."""
    xs = float32_lattice(cfg.width, cfg.r)
    ys = float32_lattice(cfg.height, cfg.r)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    keep = predicate(gx, gy).ravel()
    x = gx.ravel()[keep].astype(np.float32)
    y = gy.ravel()[keep].astype(np.float32)
    n = x.shape[0]
    zero = np.zeros(n, np.float32)
    return FluidState(
        x=_t(x, device), y=_t(y, device), u=_t(zero, device), v=_t(zero, device),
        m=_t(np.full(n, np.float32(cfg.particle_mass)), device),
        rho=_t(np.full(n, np.float32(cfg.rho_0)), device), p=_t(zero, device))


def build_box_boundary(cfg: SPHConfig, device) -> BoundaryState:
    """Single-layer box walls at spacing R (`pi_sph_fluid.c:513-540`); the
    pseudo-mass is left at 0 for models.boundary.prepare_boundary."""
    xs = float32_lattice(cfg.width, cfg.r)
    ys = float32_lattice(cfg.height, cfg.r)
    bx, by = [], []
    for x0 in xs:
        bx += [x0, x0]
        by += [np.float32(0.0), np.float32(cfg.height)]
    for y0 in ys:
        bx += [np.float32(0.0), np.float32(cfg.width)]
        by += [y0, y0]
    n = len(bx)
    zero = np.zeros(n, np.float32)
    return BoundaryState(
        x=_t(np.asarray(bx, np.float32), device),
        y=_t(np.asarray(by, np.float32), device),
        u=_t(zero, device), v=_t(zero, device), m=_t(zero, device),
        rho=_t(np.full(n, np.float32(cfg.rho_0)), device))


def build_drop_scene(cfg: SPHConfig, device) -> tuple[FluidState, BoundaryState]:
    """The reference scene: circular drop mid-domain + box walls."""
    return (build_fluid(cfg, in_circle_drop(cfg), device),
            build_box_boundary(cfg, device))


def build_dam_break_scene(cfg: SPHConfig, device, fill_x: float = 0.4,
                          fill_y: float = 0.8) -> tuple[FluidState, BoundaryState]:
    """Dam break: a fluid column in the left ``fill_x`` of the domain up to
    ``fill_y`` of its height, 2R off the walls (`scene.py:116-133`)."""
    x_max = np.float32(cfg.width) * np.float32(fill_x)
    y_max = np.float32(cfg.height) * np.float32(fill_y)
    gap = np.float32(cfg.r) * np.float32(2.0)

    def predicate(x, y):
        return (x >= gap) & (x < x_max) & (y >= gap) & (y < y_max)

    return build_fluid(cfg, predicate, device), build_box_boundary(cfg, device)


def build_pool_scene(cfg: SPHConfig, device, fill_x: float = 0.97,
                     fill_y: float = 0.85) -> tuple[FluidState, BoundaryState]:
    """A settled pool filling nearly the whole box width up to ``fill_y``
    of its height: the benchmark scene (`scene.py:136-151`)."""
    x_lo = np.float32(cfg.width) * np.float32(1.0 - fill_x)
    x_hi = np.float32(cfg.width) * np.float32(fill_x)
    y_max = np.float32(cfg.height) * np.float32(fill_y)
    gap = np.float32(cfg.r) * np.float32(2.0)

    def predicate(x, y):
        return (x >= max(gap, x_lo)) & (x <= x_hi) & (y >= gap) & (y < y_max)

    return build_fluid(cfg, predicate, device), build_box_boundary(cfg, device)


def pixel_centers(cfg: SPHConfig, rows: int = 64, cols: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """Centers of the display pixels as pseudo-particle coordinates
    (`pi_sph_fluid.c:570-577`, `scene.py:154-165`): row 0 is the top of the
    screen, y flipped.  Host numpy float32, rounded as the JAX package
    rounds them.  Returns (px, py), each (rows*cols,), index i*cols + j."""
    i = np.arange(rows, dtype=np.float64)
    j = np.arange(cols, dtype=np.float64)
    gj, gi = np.meshgrid(j, i)  # shape (rows, cols)
    px = ((gj + 0.5) * float(cfg.width) / cols).astype(np.float32)
    py = ((rows - (gi + 0.5)) * float(cfg.height) / rows).astype(np.float32)
    return px.ravel(), py.ravel()
