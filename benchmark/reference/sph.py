"""Plain PyTorch WCSPH: the reference against which the benchmark judges
what the port's timed path produced.

The physics is the upstream C source's (pi_sph_fluid.c), written from the
equations and not from the port:

* Wendland C2 kernel, W(q) = 7/(4 pi H^2) (1 - q/2)^4 (1 + 2q) for q < 2,
  H = h_factor R, support 2H (:45-61);
* density rho_i = m W(0) + sum_fluid m W_ij + sum_wall psi_b W_ib, with the
  Akinci pseudo-mass psi_b = rho_0 / sum_{b' != b} W_bb' (:242-289);
* Tait pressure B ((rho / rho_0)^7 - 1), B = c^2 rho_0 / 7, clamped at 0
  (:294-301);
* accelerations g - sum m t_ij grad W_ij - sum psi_b t_ib grad W_ib with the
  pair term pressure + Macklin artificial pressure k (W_ij / W(0.2H))^4 +
  Monaghan viscosity -alpha c mu / mean rho on approach, where
  mu = H (r . v) / (r^2 + eps H^2); a wall pair has no wall pressure and
  divides the viscosity by rho_i alone (:303-373);
* leapfrog: half kick with the old accelerations, drift, density, forces,
  half kick (:604-644).

Neighbours come from a cell list with a skin (a Verlet list), rebuilt
whenever a particle has moved half the skin since the last build, so no
pair within 2H is missed.  Every floating-point operation runs in the
``dtype`` the reference is built with: float32 for the reference, and
bfloat16 for the control that must come out as not correct.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Physics", "Reference", "pair_list", "pack_pages"]

F32 = np.float32
# candidate lanes materialised at once by pair_list
_LANES = 1 << 23


class Physics:
    """The constants of one configuration (a dict with the upstream keys),
    each rounded through float32 as the C source's float arithmetic has it."""

    def __init__(self, cfg: dict):
        r = F32(cfg["r"])
        h = F32(r * F32(cfg["h_factor"]))
        c, rho0 = F32(cfg["c"]), F32(cfg["rho_0"])
        self.r = float(r)
        self.h = float(h)
        self.support = float(F32(2.0) * h)
        self.dt = float(F32(cfg["dt_factor"]) * h / c)
        self.half_dt = float(F32(0.5) * F32(self.dt))
        self.rho0 = float(rho0)
        self.c = float(c)
        self.g = float(cfg["g"])
        self.norm = float(F32(7.0 / (4.0 * math.pi * float(h) * float(h))))
        self.mass = float(rho0 * F32(F32(cfg["v_factor"]) * h * h))
        self.tait_b = float(c * c * rho0 / F32(7.0))
        q = F32(cfg["q_artificial_pressure"])
        t = F32(1.0) - F32(0.5) * q
        self.w_ap = float(F32(self.norm) * t ** 4 * (F32(1.0) + F32(2.0) * q))
        self.k_ap = float(cfg["k_artificial_pressure"])
        self.ap_power = int(cfg["artificial_pressure_power"])
        self.alpha = float(cfg["alpha_visc"])
        self.eps = float(cfg["eps_visc"])
        self.width = float(cfg["width"])
        self.height = float(cfg["height"])


def pair_list(qx, qy, tx, ty, radius: float, lo: tuple, hi: tuple,
              exclude_self: bool = False):
    """(i, j) int64 index pairs of every query i and target j with
    |q_i - t_j| < radius, in query order, from a cell list of cell size
    ``radius`` over the box [lo, hi].  A point outside the box, or not
    finite, pairs with nothing: the walls keep a sound state a metre inside
    it, and a state that has left it is lost anyway."""
    dev = qx.device
    if qx.shape[0] == 0 or tx.shape[0] == 0:
        empty = torch.zeros(0, dtype=torch.long, device=dev)
        return empty, empty
    qx, qy, tx, ty = (a.float() for a in (qx, qy, tx, ty))
    ncx = int(math.floor((hi[0] - lo[0]) / radius)) + 1
    ncy = int(math.floor((hi[1] - lo[1]) / radius)) + 1

    def cells(x, y):
        inside = (x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1])
        x = torch.where(inside, x, torch.full_like(x, lo[0]))
        y = torch.where(inside, y, torch.full_like(y, lo[1]))
        cx = torch.clamp(((x - lo[0]) / radius).floor().long(), 0, ncx - 1)
        cy = torch.clamp(((y - lo[1]) / radius).floor().long(), 0, ncy - 1)
        return cx, cy, inside

    tcx, tcy, t_in = cells(tx, ty)
    # targets outside the box go to a bin past the grid that no query visits
    key = torch.where(t_in, tcy * ncx + tcx, torch.full_like(tcx, ncx * ncy))
    order = torch.argsort(key)
    counts = torch.bincount(key, minlength=ncx * ncy + 1)
    starts = torch.cumsum(counts, 0) - counts
    counts = counts[:ncx * ncy]
    maxc = int(counts.max())
    qcx, qcy, q_in = cells(qx, qy)
    off = torch.tensor([(ox, oy) for oy in (-1, 0, 1) for ox in (-1, 0, 1)],
                       device=dev)
    lanes = torch.arange(max(maxc, 1), device=dev)
    r2 = radius * radius
    block = max(1, _LANES // (9 * max(maxc, 1)))
    out_i, out_j = [], []
    for b0 in range(0, qx.shape[0], block):
        b1 = min(b0 + block, qx.shape[0])
        nx = qcx[b0:b1, None] + off[None, :, 0]
        ny = qcy[b0:b1, None] + off[None, :, 1]
        ok = (nx >= 0) & (nx < ncx) & (ny >= 0) & (ny < ncy) & q_in[b0:b1, None]
        k = torch.where(ok, ny * ncx + nx, torch.zeros_like(nx))
        s = starts[k]
        c = torch.where(ok, counts[k], torch.zeros_like(k))
        slot = s[:, :, None] + lanes[None, None, :]
        valid = lanes[None, None, :] < c[:, :, None]
        j = order[torch.clamp_max(slot, tx.shape[0] - 1)]
        i = torch.arange(b0, b1, device=dev)[:, None, None].expand_as(j)
        dx = qx[i] - tx[j]
        dy = qy[i] - ty[j]
        keep = valid & (dx * dx + dy * dy < r2)
        if exclude_self:
            keep &= i != j
        out_i.append(i[keep])
        out_j.append(j[keep])
    return torch.cat(out_i), torch.cat(out_j)


def pack_pages(lit: torch.Tensor) -> torch.Tensor:
    """(rows, cols) bool image -> the SSD1306 page format: byte
    (i // 8) * cols + j holds bit i % 8 (pi_sph_fluid.c:407-408)."""
    rows, cols = lit.shape
    bits = lit.reshape(rows // 8, 8, cols).to(torch.int32)
    weight = (2 ** torch.arange(8, device=lit.device, dtype=torch.int32))[None, :, None]
    return (bits * weight).sum(1).to(torch.uint8).reshape(-1)


class Reference:
    """The fluid (ids 0..n-1, in the order of the scene's inputs) and the
    static walls of one configuration, stepped in ``dtype``."""

    def __init__(self, phys: Physics, wall_x, wall_y, device,
                 dtype=torch.float32, skin_h: float = 0.5):
        self.p = phys
        self.dtype = dtype
        self.device = torch.device(device)
        self.skin = skin_h * phys.h
        self.lo = (-1.0, -1.0)
        self.hi = (phys.width + 1.0, phys.height + 1.0)
        self.bx = self._t(wall_x)
        self.by = self._t(wall_y)
        self.psi = self._psi()
        self._pairs = None
        self.lost = False

    def _t(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, self.dtype)
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype)

    # ---- the kernel ------------------------------------------------------
    def _w(self, r):
        q = r / self.p.h
        t = 1.0 - 0.5 * q
        w = self.p.norm * (t * t) * (t * t) * (1.0 + 2.0 * q)
        return torch.where(q < 2.0, w, torch.zeros_like(w))

    def _grad_coef(self, r):
        """grad_i W_ij = coef * (x_i - x_j)."""
        q = r / self.p.h
        t = 1.0 - 0.5 * q
        coef = (self.p.norm * -5.0 / (self.p.h * self.p.h)) * (t * t * t)
        return torch.where(q < 2.0, coef, torch.zeros_like(coef))

    def _psi(self) -> torch.Tensor:
        i, j = pair_list(self.bx, self.by, self.bx, self.by, self.p.support,
                         self.lo, self.hi, exclude_self=True)
        dx, dy = self.bx[i] - self.bx[j], self.by[i] - self.by[j]
        s = torch.zeros_like(self.bx).index_add_(0, i, self._w(torch.sqrt(dx * dx + dy * dy)))
        return self.p.rho0 / s

    # ---- neighbours --------------------------------------------------------
    def _neighbours(self):
        """The fluid-fluid and fluid-wall pairs within 2H of the current
        positions, from a list within 2H + skin kept until some particle
        has moved skin / 2 since it was built."""
        x, y = self.x.float(), self.y.float()
        if self._pairs is not None:
            x0, y0 = self._pairs[2]
            moved = torch.max((x - x0) ** 2 + (y - y0) ** 2)
            if not bool(moved < (0.5 * self.skin) ** 2):
                self._pairs = None
        if self._pairs is None:
            rad = self.p.support + self.skin
            ff = pair_list(x, y, x, y, rad, self.lo, self.hi, exclude_self=True)
            fb = pair_list(x, y, self.bx, self.by, rad, self.lo, self.hi)
            self._pairs = (ff, fb, (x.clone(), y.clone()))
        return self._pairs[0], self._pairs[1]

    # ---- the physics -------------------------------------------------------
    def _density(self):
        (i, j), (ib, b) = self._neighbours()
        x, y = self.x, self.y
        dx, dy = x[i] - x[j], y[i] - y[j]
        w = self._w(torch.sqrt(dx * dx + dy * dy))
        dxb, dyb = x[ib] - self.bx[b], y[ib] - self.by[b]
        wb = self._w(torch.sqrt(dxb * dxb + dyb * dyb))
        m = self.p.mass
        rho = torch.full_like(x, m * self.p.norm)
        rho.index_add_(0, i, m * w)
        rho.index_add_(0, ib, self.psi[b] * wb)
        ratio = rho / self.p.rho0
        r2 = ratio * ratio
        p = torch.clamp_min(self.p.tait_b * (r2 * r2 * r2 * ratio - 1.0), 0.0)
        return rho, p

    def _artificial(self, w):
        ratio = w / self.p.w_ap
        return self.p.k_ap * ratio ** self.p.ap_power

    def _accel(self, rho, p, g):
        (i, j), (ib, b) = self._neighbours()
        x, y, u, v, h = self.x, self.y, self.u, self.v, self.p.h
        visc = -self.p.alpha * self.p.c
        eps_h2 = self.p.eps * h * h
        pr = p / (rho * rho)
        # fluid-fluid
        dx, dy = x[i] - x[j], y[i] - y[j]
        du, dv = u[i] - u[j], v[i] - v[j]
        r = torch.sqrt(dx * dx + dy * dy)
        dot = dx * du + dy * dv
        mu = h * dot / (dx * dx + dy * dy + eps_h2)
        t = pr[i] + pr[j] + self._artificial(self._w(r))
        t = t + torch.where(dot < 0.0, visc * mu / ((rho[i] + rho[j]) * 0.5),
                            torch.zeros_like(mu))
        k = self.p.mass * t * self._grad_coef(r)
        ax = torch.full_like(x, g[0]).index_add_(0, i, -k * dx)
        ay = torch.full_like(x, g[1]).index_add_(0, i, -k * dy)
        # fluid-wall: the wall is still and carries no pressure
        dx, dy = x[ib] - self.bx[b], y[ib] - self.by[b]
        du, dv = u[ib], v[ib]
        r = torch.sqrt(dx * dx + dy * dy)
        dot = dx * du + dy * dv
        mu = h * dot / (dx * dx + dy * dy + eps_h2)
        t = pr[ib] + self._artificial(self._w(r))
        t = t + torch.where(dot < 0.0, visc * mu / rho[ib], torch.zeros_like(mu))
        k = self.psi[b] * t * self._grad_coef(r)
        ax.index_add_(0, ib, -k * dx)
        ay.index_add_(0, ib, -k * dy)
        return ax, ay

    # ---- driving -----------------------------------------------------------
    def load(self, x, y, u, v, au=None, av=None):
        """Set the fluid state (ids 0..n-1) and drop the neighbour list."""
        self.x, self.y, self.u, self.v = (self._t(a) for a in (x, y, u, v))
        zero = torch.zeros_like(self.x)
        self.au = zero if au is None else self._t(au)
        self.av = zero if av is None else self._t(av)
        self._pairs = None
        self.lost = False

    def prime(self, x, y, g):
        """The step-0 pass (pi_sph_fluid.c:604-607) from positions at rest:
        density, pressure and the first accelerations."""
        self.load(x, y, torch.zeros_like(torch.as_tensor(x)),
                  torch.zeros_like(torch.as_tensor(x)))
        self.rho, self.pres = self._density()
        self.au, self.av = self._accel(self.rho, self.pres, g)

    def tick(self, g):
        hd, dt = self.p.half_dt, self.p.dt
        self.u = self.u + hd * self.au
        self.v = self.v + hd * self.av
        self.x = self.x + dt * self.u
        self.y = self.y + dt * self.v
        self.rho, self.pres = self._density()
        self.au, self.av = self._accel(self.rho, self.pres, g)
        self.u = self.u + hd * self.au
        self.v = self.v + hd * self.av

    def run(self, g_trace):
        """One tick per row of the (K, 2) gravity trace.  A state that is no
        longer finite, or moves faster than sound, is lost: stepping stops
        there (the control's bfloat16 gets there; a sound run never does)."""
        for g in np.asarray(g_trace, np.float64):
            self.tick((float(g[0]), float(g[1])))
            speed2 = torch.max(self.u.float() ** 2 + self.v.float() ** 2)
            if not bool(speed2 <= self.p.c ** 2):
                self.lost = True
                return

    def render(self, rows: int, cols: int) -> torch.Tensor:
        """The metaball frame of the fluid (pi_sph_fluid.c:380-411): pixel
        (i, j) at ((j + 0.5) W / cols, (rows - i - 0.5) H / rows), row 0 at
        the top, lit where sum_j W(pixel, x_j) / W(w_px / 2) >= 1, with w_px
        the pitch of the upstream 128-column raster (a W of 0 there stands
        at 1e-30: any particle in support lights the pixel).  Returns the
        page-packed uint8 framebuffer."""
        gi, gj = np.meshgrid(np.arange(rows, dtype=np.float64),
                             np.arange(cols, dtype=np.float64), indexing="ij")
        px = self._t(((gj + 0.5) * self.p.width / cols).astype(np.float32).ravel())
        py = self._t(((rows - (gi + 0.5)) * self.p.height / rows).astype(np.float32).ravel())
        half_px = F32(F32(self.p.width) / F32(128.0)) / F32(2.0)
        w_ref = float(self._w(torch.tensor(float(half_px), dtype=torch.float32)))
        w_ref = w_ref if w_ref > 0.0 else float(F32(1e-30))
        i, j = pair_list(px, py, self.x, self.y, self.p.support, self.lo, self.hi)
        dx, dy = px[i] - self.x[j], py[i] - self.y[j]
        field = torch.zeros_like(px).index_add_(0, i, self._w(torch.sqrt(dx * dx + dy * dy)))
        return pack_pages((field / w_ref >= 1.0).reshape(rows, cols))
