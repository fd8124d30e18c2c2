"""Deciding `correct`: what the port's timed path produced, held against the
plain reference (reference/).

The reference cannot replay a whole window (a run of tens of thousands of
ticks parts from any second computation as chaos grows, and would take
longer than the window), so it follows the program step by step: for each
checked dispatch it starts from the program's own input state (positions,
velocities and the leapfrog's carried accelerations, by particle id) and
runs the same K ticks with the same gravity trace, then renders its own
frame.  The start, which that skips, is checked by itself: the wall
pseudo-masses and the primed state against the reference's own, from the
benchmark's inputs.

Numbers (each the worst over what was checked):

* ``psi``: max relative gap of a wall pseudo-mass;
* ``prime_rho``: max |d rho| / rho_0 of the primed state;
* ``prime_acc``: max |d a| / g of the primed accelerations;
* ``pos``: max |d x|, |d y| / R after a dispatch;
* ``step``: the same gap over the largest move the reference makes in the
  dispatch, so a step that leaves the state where it was reads 1;
* ``vel``: max |d u|, |d v| in m/s after a dispatch;
* ``rho``: max |d rho| / rho_0 after a dispatch;
* ``frame``: pixels that differ between the dispatch's frame and the
  reference's (none in a headless run, which draws no frame);
* ``failed`` (added by the harness, limit 0): committed dispatches of the
  window that ended with lost pairs or stale drift the runner did not
  recover, sampled or not.

A dispatch's gaps saturate where they stop meaning anything: a position
at the box's size, a velocity at the speed of sound c, a density at
rho_0; a gap that is not a number reads as the saturation.  So every
state, the bfloat16 control's that leaves the box included, gives a
number.  A start number that is not finite reads as infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import Reference

__all__ = ["start_numbers", "reference_outputs", "dispatch_numbers", "worst", "verdict"]


def _max(t: torch.Tensor, cap: float = math.inf) -> float:
    if t.numel() == 0:
        return 0.0
    t = torch.nan_to_num(t.double().abs(), nan=cap, posinf=cap).clamp_max(cap)
    return float(t.max())


def _walls_sorted(x, y, m):
    """Walls in (x, y) order, so that two sides can be compared row by row
    (coincident walls have the same pseudo-mass)."""
    x, y, m = (np.asarray(a.detach().float().cpu(), np.float64) for a in (x, y, m))
    order = np.lexsort((m, y, x))
    return m[order]


def start_numbers(ref: Reference, fluid_xy, g0, primed: dict, walls: tuple) -> dict:
    """The start: ``walls`` (x, y, psi) and the primed state ``primed``
    (rho, au, av by id) of the side under test, against ``ref``'s own
    pseudo-masses and its prime from the scene's positions ``fluid_xy``."""
    psi_t = _walls_sorted(*walls)
    psi_r = _walls_sorted(ref.bx, ref.by, ref.psi)
    psi = float(np.max(np.nan_to_num(np.abs(psi_t - psi_r) / np.abs(psi_r), nan=np.inf)))
    ref.prime(fluid_xy[0], fluid_xy[1], g0)
    p = ref.p
    drho = primed["rho"].double() - ref.rho.double()
    dacc = torch.cat([primed["au"].double() - ref.au.double(),
                      primed["av"].double() - ref.av.double()])
    return dict(psi=psi, prime_rho=_max(drho) / p.rho0, prime_acc=_max(dacc) / p.g)


def reference_outputs(ref: Reference, inp: dict, g_trace, shape):
    """The reference's state (x, y, u, v, rho by id) and frame after the K
    ticks of ``g_trace`` from the input state ``inp`` (x, y, u, v, au, av);
    no frame (None) for a headless run, whose ``shape`` is None."""
    ref.load(inp["x"], inp["y"], inp["u"], inp["v"], inp["au"], inp["av"])
    ref.run(g_trace)
    out = dict(x=ref.x, y=ref.y, u=ref.u, v=ref.v, rho=ref.rho)
    return out, (ref.render(*shape) if shape else None)


def _pixels(a: torch.Tensor, b: torch.Tensor) -> int:
    x = torch.bitwise_xor(a.to(torch.uint8), b.to(a.device, torch.uint8)).to(torch.int32)
    bits = (x[:, None] >> torch.arange(8, device=x.device, dtype=torch.int32)) & 1
    return int(bits.sum())


def dispatch_numbers(inp: dict, out: dict, fb, ref_out: dict, ref_fb, phys) -> dict:
    """One dispatch's state and frame against the reference's, both from
    the input state ``inp``; a headless dispatch (``fb`` None) has no
    ``frame`` number."""
    d = lambda k: out[k].double() - ref_out[k].double()  # noqa: E731
    box = max(phys.width, phys.height)
    gap = _max(torch.cat([d("x"), d("y")]), box)
    moved = _max(torch.cat([ref_out["x"].double() - inp["x"].double(),
                            ref_out["y"].double() - inp["y"].double()]), box)
    nums = dict(pos=gap / phys.r,
                step=gap / moved if moved > 0 else (0.0 if gap == 0 else math.inf),
                vel=_max(torch.cat([d("u"), d("v")]), phys.c),
                rho=_max(d("rho"), phys.rho0) / phys.rho0)
    if fb is not None:
        nums["frame"] = float(_pixels(fb, ref_fb))
    return nums


def worst(rows: list) -> dict:
    """The largest of each number over several checks."""
    out: dict = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit is finite and within it, and every
    limit has a number."""
    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())
