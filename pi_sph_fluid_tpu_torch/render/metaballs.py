"""Blinn metaball renderer -> SSD1306 page-packed framebuffer, the oracle
(port of `pi_sph_fluid_tpu/render/metaballs.py:33-86`).

Implements `draw_metaballs` (`pi_sph_fluid.c:380-411`) with the reference's
abstraction that pixels are particles (`pi_sph_fluid.c:567-577`): pixel
centers query the same counting-sort grid as the physics.  Per pixel:
field = sum_j W(pixel, fluid_j) / W(px_width/2), lit when >= 1.

Output layout is the SSD1306 page format (`pi_sph_fluid.c:407-408`): byte
(i/8)*cols + j holds bit i%8, 1024 bytes at 64x128.  The production path is
render/metaballs_window.py; this one gathers dense candidate lists and
serves as its reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SPHConfig
from ..core.kernels import div_scalar, kernel_w, kernel_w_scalar
from ..models.scene import pixel_centers
from ..ops.grid import build_grid
from ..ops.neighbors import gather_candidates

__all__ = ["make_renderer", "metaball_field", "pack_framebuffer",
           "unpack_framebuffer", "w_ref_of"]


def w_ref_of(cfg: SPHConfig) -> float:
    """W(px_width/2) of the reference's 128-column raster, in float32."""
    px_width = np.float32(cfg.width) / np.float32(128.0)
    r = torch.tensor(np.float32(px_width) / np.float32(2.0))
    return float(kernel_w_scalar(r, cfg))


def metaball_field(px, py, fx, fy, grid, cfg: SPHConfig, cap: int | None = None):
    """Raw metaball field per pixel (>= 1 means lit); ``fx``, ``fy`` in the
    grid's sorted order."""
    cand = gather_candidates(px, py, grid, cfg, cap=cap)
    idx = cand.idx.long()
    w = kernel_w(px[:, None] - fx[idx], py[:, None] - fy[idx], cfg)
    total = torch.where(cand.valid, w, torch.zeros_like(w)).sum(1)
    return div_scalar(total, w_ref_of(cfg))


def pack_framebuffer(lit: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """(rows, cols) bool -> page-packed uint8 buffer of rows/8*cols bytes."""
    pages = rows // 8
    bits = lit.reshape(pages, 8, cols).to(torch.int32)
    weights = torch.bitwise_left_shift(
        torch.ones(8, dtype=torch.int32, device=lit.device),
        torch.arange(8, dtype=torch.int32, device=lit.device))
    return (bits * weights[None, :, None]).sum(1).to(torch.uint8).reshape(pages * cols)


def unpack_framebuffer(buf, rows: int = 64, cols: int = 128) -> np.ndarray:
    """Packed buffer -> (rows, cols) bool image (host-side, for tests/sinks):
    row i lives in page i//8, bit i%8 (`pi_sph_fluid.c:407`)."""
    b = np.asarray(buf, np.uint8).reshape(rows // 8, 1, cols)
    shifts = np.arange(8, dtype=np.uint8)[None, :, None]
    return ((b >> shifts) & 1).reshape(rows, cols).astype(bool)


def make_renderer(cfg: SPHConfig, rows: int = 64, cols: int = 128,
                  cap: int | None = None):
    """``render(fluid) -> (rows/8*cols,) uint8`` on the fluid's device.

    Takes the fluid in any order: positions are permuted by the grid's
    order before the field gather (`metaballs.py:64-73`)."""
    px_np, py_np = pixel_centers(cfg, rows, cols)

    def render(fluid):
        dev = fluid.x.device
        px, py = torch.as_tensor(px_np, device=dev), torch.as_tensor(py_np, device=dev)
        grid = build_grid(fluid.x, fluid.y, cfg)
        order = grid.order.long()
        field = metaball_field(px, py, fluid.x[order], fluid.y[order], grid, cfg, cap=cap)
        return pack_framebuffer((field >= 1.0).reshape(rows, cols), rows, cols)

    return render
