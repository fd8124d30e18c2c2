"""Render cost at scale: a frame drawn through the engine's own relayout
frame against one that sorts the fluid itself (port of
`tools/render_probe.py`).

Builds bench.py's pool at ``--n`` particles, primes it, runs one sticky
group of ``--resort`` ticks with ``return_frame=True``, then times
``WindowRenderer.render_from_frame(sim, frame)`` (frame reuse) and
``WindowRenderer.render(sim)`` (the self-relayout mode), ``--reps`` frames
each after one untimed warm-up, by the host clock between two
synchronisations of the device.  Both go through the field kernel
(csrc/window_kernels.cu) on a card, and the physics ticks before them
through the density and forces kernels.

    python -m pi_sph_fluid_tpu_torch.tools.render_probe [--n 1000000]
        [--rows 64 --cols 128] [--device cuda|cpu]

``main`` returns both overflow counts, both ms a frame and the renderer's
caps.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from ..config import SPHConfig
from ..models.boundary import prepare_boundary
from ..models.engine_v3 import WindowEngine
from ..models.scene import build_pool_scene
from ..render.metaballs_window import WindowRenderer
from ..utils.profiling import resolve_device, wall_ms

G = (0.0, -9.81)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="render_probe")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--cols", type=int, default=128)
    ap.add_argument("--resort", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device, kind = resolve_device(args.device, "render_probe")

    cfg = SPHConfig(r=math.sqrt(6.35 / args.n))
    fluid, braw = build_pool_scene(cfg, device)
    boundary, bgrid = prepare_boundary(braw, cfg)
    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, device)
    rend = WindowRenderer(eng, args.rows, args.cols)
    out = dict(device=kind, n=fluid.n, rows=args.rows, cols=args.cols,
               reuse_cap=rend.reuse_spec.cap, self_cap=rend.spec.cap,
               px_layout=rend.spec.n_layout)
    print(f"n={fluid.n} on {kind}: reuse_cap={out['reuse_cap']} "
          f"self_cap={out['self_cap']} px_layout={out['px_layout']}", flush=True)
    sim = eng.prime(fluid, G)
    multi = eng.make_multi_step(resort_every=args.resort, return_frame=True)
    sim, st, frame = multi(sim, np.tile(np.float32(G), (args.resort, 1)))
    out["step_overflow"] = int(st.neighbor_overflow.max())

    _, ov = rend.render_from_frame(sim, frame)
    out["reuse_overflow"] = int(ov)
    out["render_from_frame_ms"] = wall_ms(lambda: rend.render_from_frame(sim, frame),
                                          args.reps, device)
    print(f"reuse overflow={out['reuse_overflow']}\n"
          f"render_from_frame: {out['render_from_frame_ms']:8.3f} ms/frame", flush=True)
    _, ov = rend.render(sim)
    out["self_overflow"] = int(ov)
    out["self_relayout_ms"] = wall_ms(lambda: rend.render(sim), args.reps, device)
    print(f"self overflow={out['self_overflow']}\n"
          f"self-relayout:     {out['self_relayout_ms']:8.3f} ms/frame", flush=True)
    return out


if __name__ == "__main__":
    main()
