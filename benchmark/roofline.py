"""The yardstick of a kernel's roofline share: the card's peaks, the work
of each pass counted from the inputs (never from the port's layout), and
the least time the card needs for it.

The work is what the physics requires whatever implements it: the pairs
within the support radius 2H, taken from the benchmark's own cell list
on the state, each fluid row read once and written once, and each wall
row within reach of the fluid read once.
"""

from __future__ import annotations

import subprocess

import torch

from .reference import pair_list

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "COST", "KICK_DRIFT_ROW_BYTES",
           "pair_counts", "pass_work", "tick_work", "least_s", "power_limit"]

# NVIDIA H100 SXM data sheet, at its 700 W limit: float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12

# Operations a pair lane (the FLOPs of the kernels' pair loops), and
# device-memory bytes per query row (inputs read, outputs written once)
# and per distinct wall row.  Density reads a packed row (32 B) and
# writes geo8 (32 B) and [rho, p] (8 B); forces read the packed row, geo8
# and [rho, p] and write the next packed row and [au, av].  Wall rows are
# [x, y, psi, 0] (16 B) for density and 8 floats (32 B) for forces.
COST = {"density": dict(flops=16, row_bytes=32 + 32 + 8, wall_bytes=16),
        "forces": dict(flops=39, row_bytes=32 + 32 + 8 + 32 + 8, wall_bytes=32)}
# the kick-drift: the packed row and [au, av] read, the packed row written
KICK_DRIFT_ROW_BYTES = 32 + 8 + 32


def pair_counts(x, y, wall_x, wall_y, support: float, box: tuple) -> dict:
    """Ordered fluid-fluid pairs (i != j) and fluid-wall pairs within
    ``support`` (strictly), and the wall rows that some fluid row reaches."""
    lo, hi = (-1.0, -1.0), (box[0] + 1.0, box[1] + 1.0)
    ff, _ = pair_list(x, y, x, y, support, lo, hi, exclude_self=True)
    _, b = pair_list(x, y, wall_x, wall_y, support, lo, hi)
    return dict(n_fluid=int(x.shape[0]), ff=int(ff.shape[0]), fb=int(b.shape[0]),
                walls=int(torch.unique(b).shape[0]))


def pass_work(kind: str, pc: dict) -> tuple:
    """(FLOPs, bytes) of one density or forces pass over these pairs."""
    c = COST[kind]
    pairs = pc["ff"] + pc["fb"]
    return (c["flops"] * pairs,
            c["row_bytes"] * pc["n_fluid"] + c["wall_bytes"] * pc["walls"])


def tick_work(pc: dict) -> tuple:
    """(FLOPs, bytes) of one tick of the stepper: kick-drift, density and
    forces."""
    fd, bd = pass_work("density", pc)
    ff, bf = pass_work("forces", pc)
    return fd + ff, bd + bf + KICK_DRIFT_ROW_BYTES * pc["n_fluid"]


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card needs: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    'not read'."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"
