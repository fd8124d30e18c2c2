"""The benchmark's inputs: the particle lattice, the box walls and the
seeded jitter, as host numpy float32.

The lattice is the upstream build's float32 loop, `for (float a = 0; a <
stop; a += step)` (pi_sph_fluid.c:475-540), and the walls its single-layer
box at spacing R.  Both the port and the plain reference are handed these
arrays, so neither derives its inputs from the other.
"""

from __future__ import annotations

import numpy as np

__all__ = ["float32_lattice", "build_scene", "rng"]

F32 = np.float32


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream): the same seed gives the
    same inputs, and each input draws from a stream of its own."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def float32_lattice(stop: float, step: float, start: float = 0.0) -> np.ndarray:
    """Values of ``for (float a = start; a < stop; a += step)`` in float32."""
    out = []
    a, stop32, step32 = F32(start), F32(stop), F32(step)
    while a < stop32:
        out.append(a)
        a = F32(a + step32)
    return np.asarray(out, np.float32)


def _fluid_lattice(cfg: dict, xs: np.ndarray, ys: np.ndarray):
    """(x, y) of the scene's fluid before the jitter, outer x, inner y."""
    r, w, h = F32(cfg["r"]), F32(cfg["width"]), F32(cfg["height"])
    if cfg["scene"] == "tank":
        # the box's lattice from wall_gap_r * R off both side walls and the
        # floor up to fill * height: a free surface below the lid
        gap = F32(cfg["wall_gap_r"]) * r
        top = F32(cfg["fill"]) * h
        keep_x, keep_y = xs[(xs >= gap) & (xs <= w - gap)], ys[(ys >= gap) & (ys < top)]
        gx, gy = np.meshgrid(keep_x, keep_y, indexing="ij")
        return gx.ravel(), gy.ravel()
    if cfg["scene"] == "drop":
        # the upstream circle of radius 0.70 m mid-box on the box's lattice
        # (pi_sph_fluid.c:238-240, 484-506)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        dx, dy = gx - w / F32(2.0), gy - h / F32(2.0)
        dist = np.sqrt((dx * dx + dy * dy).astype(np.float32), dtype=np.float32)
        keep = (dist < cfg["drop_radius"]).ravel()
        return gx.ravel()[keep], gy.ravel()[keep]
    if cfg["scene"] == "dam":
        # a column from 2 R off the left wall and the floor to fill_x of the
        # width and fill_y of the height, as the port's
        # models/scene.py::build_dam_break_scene lays it out
        gap = r * F32(2.0)
        x_max, y_max = w * F32(cfg["fill_x"]), h * F32(cfg["fill_y"])
        keep_x, keep_y = xs[(xs >= gap) & (xs < x_max)], ys[(ys >= gap) & (ys < y_max)]
        gx, gy = np.meshgrid(keep_x, keep_y, indexing="ij")
        return gx.ravel(), gy.ravel()
    raise ValueError(f"unknown scene {cfg['scene']!r}")


def build_scene(cfg: dict, seed: int) -> dict:
    """{fluid_x, fluid_y, wall_x, wall_y}: float32 arrays.  The fluid is the
    scene's lattice points (outer x, inner y, as the upstream loop), each
    moved by a seeded uniform jitter of at most ``jitter_r`` * R a
    coordinate; the walls are not jittered."""
    xs = float32_lattice(cfg["width"], cfg["r"])
    ys = float32_lattice(cfg["height"], cfg["r"])
    fx, fy = _fluid_lattice(cfg, xs, ys)
    amp = F32(cfg["jitter_r"]) * F32(cfg["r"])
    jit = rng(seed, 0).uniform(-1.0, 1.0, size=(2, fx.shape[0])).astype(np.float32)
    fx = (fx + amp * jit[0]).astype(np.float32)
    fy = (fy + amp * jit[1]).astype(np.float32)
    wx, wy = [], []
    for x0 in xs:
        wx += [x0, x0]
        wy += [F32(0.0), F32(cfg["height"])]
    for y0 in ys:
        wx += [F32(0.0), F32(cfg["width"])]
        wy += [y0, y0]
    return dict(fluid_x=fx, fluid_y=fy, wall_x=np.asarray(wx, np.float32),
                wall_y=np.asarray(wy, np.float32))
