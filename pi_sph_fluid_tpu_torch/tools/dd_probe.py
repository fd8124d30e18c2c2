"""Sticky groups against exact steps of the slab decomposition on one slab
(port of `tools/dd_probe.py`).

Builds bench.py's pool at ``--n`` particles as a ``WindowDomain`` of one
slab over ``LocalComm(1)``, so that one card runs the whole machinery
(migration, the halo exchange with itself, the per-slab relayout and
both kernels), and runs ``--steps`` ticks at ``resort_every`` 1, 4 and 8,
each from the same initial state after one untimed group, timed by the
host clock between two synchronisations of the device.

    python -m pi_sph_fluid_tpu_torch.tools.dd_probe [--n 100000]
        [--steps 64] [--device cuda|cpu]

``main`` returns, for each period, ms a step, particle-steps a second, the
largest ``overflow`` of any tick and the last tick's ``n_valid`` (the
stats dict of parallel/domain_window.py).
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from ..config import SPHConfig
from ..models.boundary import prepare_boundary
from ..models.scene import build_pool_scene
from ..parallel import LocalComm, WindowDomain
from ..utils.profiling import resolve_device, timed

G = (0.0, -9.81)
RESORTS = (1, 4, 8)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="dd_probe")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=64,
                    help="ticks a period (a multiple of 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device, kind = resolve_device(args.device, "dd_probe")
    if args.steps % max(RESORTS):
        raise SystemExit(f"--steps must be a multiple of {max(RESORTS)}")

    cfg = SPHConfig(r=math.sqrt(6.35 / args.n))
    fluid, braw = build_pool_scene(cfg, device)
    boundary, bgrid = prepare_boundary(braw, cfg)
    dd = WindowDomain(cfg, boundary, bgrid, fluid.n, LocalComm(1), device)
    state = dd.init(fluid)
    out = dict(device=kind, n=fluid.n, steps=args.steps)
    for k in RESORTS:
        multi = dd.make_multi_step(resort_every=k)
        multi(state, np.tile(np.float32(G), (k, 1)))      # untimed: one group
        (_, st), wall = timed(
            lambda: multi(state, np.tile(np.float32(G), (args.steps, 1))), device)
        row = dict(ms_per_step=wall / args.steps * 1e3,
                   ps_per_s=fluid.n * args.steps / wall,
                   overflow=int(st["overflow"].max()),
                   n_valid=int(st["n_valid"][-1]))
        print(f"resort={k}: {row['ms_per_step']:7.3f} ms/step  "
              f"{row['ps_per_s'] / 1e6:7.2f} M ps/s  ovf={row['overflow']} "
              f"n_valid={row['n_valid']}", flush=True)
        out[f"r{k}"] = row
    return out


if __name__ == "__main__":
    main()
