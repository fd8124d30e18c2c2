"""Headline benchmark of the port: WCSPH particle-steps per second on one
GPU (port of the repository's `bench.py`).

Runs the pool scene (settled steady state, the layout's sizing case)
through WindowEngine, free-running (REALTIME off, `pi_sph_fluid.c:10`), and
prints ONE JSON line with bench.py's keys:

* ``value``: particle-steps/s at 100k particles and resort_every=64 (the
  runtime ladder's ceiling), the median of 3 dispatches of 384 ticks, with
  ``ps_per_s_min`` / ``ps_per_s_max``; ``exact_ps_per_s`` at resort_every=1;
* ``stale_drift``: real particles that drifted past the 0.3*H fringe margin
  on a carried tick of the r64 run (the drift guard; it must read 0),
  ``neighbor_overflow`` (window lanes lost to the cap; must read 0) and
  ``max_rho_error_pct``;
* ``frame_ms`` / ``render_overflow``: one 64x128 ``render_from_frame`` from
  the r64 run's last relayout frame, over 10 frames;
* ``smallN_ticks_per_s`` / ``smallN_vs_realtime``: the reference's own
  operating point, the 269-particle drop (`pi_sph_fluid.c:484-543`), at
  tq=32, qb=8, resort_every=4, 4096 ticks, against its enforced 4102
  ticks/s (`pi_sph_fluid.c:694-701`);
* ``m1``: the 1M-particle pool at resort_every=64, 64 ticks;
* ``vs_baseline``: against the reference's implied real-time throughput on
  a Raspberry Pi 4, 431 particles x 4102 ticks/s (BASELINE.md);
* ``device``: the card's name.

Not carried over: the slab domain-decomposition rows ``dd`` and
``dd_strong`` (WindowDomain is not ported: ``not_ported`` names them), the
echo of earlier TPU headlines, and the CPU fallback.  Without a CUDA device
the bench raises unless ``--device cpu`` is given, which runs the same code
through the kernels' plain versions (for tests, at small sizes).

    python -m pi_sph_fluid_tpu_torch.bench
    python -m pi_sph_fluid_tpu_torch.bench --device cpu --n 2000 --steps 64 --m1-n 3000 --small-steps 16
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .config import SPHConfig
from .models.boundary import prepare_boundary
from .models.engine_v3 import WindowEngine
from .models.scene import build_drop_scene
from .render.metaballs_window import WindowRenderer
from .utils.profiling import pool_engine

__all__ = ["main", "bench_window", "bench_small", "bench_1m"]

BASELINE_PS = 431 * 4102   # the reference's implied particle-steps/s (BASELINE.md)
REALTIME_TICKS = 4102      # the reference's enforced tick rate (`pi_sph_fluid.c:694-701`)
RESORT = 64                # the runtime ladder's ceiling
M1_STEPS = 64
N_FRAMES = 10
G = (0.0, -9.81)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gravity(n: int) -> np.ndarray:
    return np.tile(np.float32(G), (n, 1))


def _timed(multi, sim, g, device):
    """(wall seconds, outputs) of one ``multi(sim, g)`` after a warm-up call
    of the same length."""
    multi(sim, g)
    _sync(device)
    t0 = time.perf_counter()
    out = multi(sim, g)
    _sync(device)
    return time.perf_counter() - t0, out


def bench_window(n: int, steps: int, device: torch.device) -> dict:
    """The pool at about ``n`` particles: r64 (median of 3 with min and
    max), r1, and the 64x128 frame from the r64 run's frame."""
    eng, fluid = pool_engine(n, device)
    sim = eng.prime(fluid, G)
    g = _gravity(steps)
    sticky = eng.make_multi_step(resort_every=RESORT, return_frame=True)
    sticky(sim, g)                                     # warm-up
    walls = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        sim64, st64, frame = sticky(sim, g)
        _sync(device)
        walls.append(time.perf_counter() - t0)
    wall64 = statistics.median(walls)
    wall1, _ = _timed(eng.make_multi_step(resort_every=1), sim, g, device)

    rend = WindowRenderer(eng, 64, 128)
    rend.render_from_frame(sim64, frame)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(N_FRAMES):
        fb, f_ov = rend.render_from_frame(sim64, frame)
    _sync(device)
    frame_ms = (time.perf_counter() - t0) / N_FRAMES * 1e3
    return {
        "n_fluid": fluid.n,
        "steps": steps,
        "wall_s": wall64,
        "ps_per_s": fluid.n * steps / wall64,
        "ps_per_s_min": fluid.n * steps / max(walls),
        "ps_per_s_max": fluid.n * steps / min(walls),
        "exact_ps_per_s": fluid.n * steps / wall1,
        "resort_every": RESORT,
        "stale_drift": int(st64.stale.sum()),
        "scene": "pool",
        "max_rho_error_pct": float(st64.max_rho_error_pct.max()),
        "neighbor_overflow": int(st64.neighbor_overflow.max()),
        "frame_ms": frame_ms,
        "render_overflow": int(f_ov),
    }


def bench_small(steps: int, device: torch.device) -> dict:
    """The reference's operating point: the 269-particle drop at tq=32,
    qb=8, cap=256, resort_every=4 (`bench.py:101-112`)."""
    cfg = SPHConfig()
    fluid, braw = build_drop_scene(cfg, device)
    b, bg = prepare_boundary(braw, cfg)
    eng = WindowEngine(cfg, b, bg, fluid.n, device, tq=32, qb=8, cap=256, seg_q=2)
    wall, _ = _timed(eng.make_multi_step(resort_every=4), eng.prime(fluid, G),
                     _gravity(steps), device)
    return {"smallN_ticks_per_s": steps / wall,
            "smallN_vs_realtime": steps / wall / REALTIME_TICKS}


def bench_1m(n: int, steps: int, device: torch.device) -> dict:
    """The 1M-particle north-star operating point (BASELINE.md: 1M at 60+
    steps/s), at resort_every=64."""
    eng, fluid = pool_engine(n, device)
    wall, (_, st) = _timed(eng.make_multi_step(resort_every=RESORT),
                           eng.prime(fluid, G), _gravity(steps), device)
    return {
        "n_fluid": fluid.n,
        "ps_per_s": fluid.n * steps / wall,
        "steps_per_s": steps / wall,
        "ms_per_step": wall / steps * 1e3,
        "stale_drift": int(st.stale.sum()),
        "neighbor_overflow": int(st.neighbor_overflow.max()),
    }


def _device(name: str) -> tuple[torch.device, str]:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA device (torch.cuda.is_available() is "
                             "False); pass --device cpu to run the plain versions")
        return device, torch.cuda.get_device_name(device)
    if device.type != "cpu":
        raise SystemExit(f"bench: unsupported device {name!r}")
    return device, "cpu"


def main(argv=None) -> dict:
    """Prints the JSON line and returns it as a dict."""
    ap = argparse.ArgumentParser(prog="pi_sph_fluid_tpu_torch.bench")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n", type=int, default=100_000, help="pool particles")
    ap.add_argument("--steps", type=int, default=384,
                    help="ticks per dispatch (a multiple of 64)")
    ap.add_argument("--m1-n", type=int, default=1_000_000, help="m1 pool particles")
    ap.add_argument("--small-steps", type=int, default=4096,
                    help="ticks of the 269 drop (a multiple of 4)")
    args = ap.parse_args(argv)
    if args.steps % RESORT or args.small_steps % 4:
        raise SystemExit("--steps must be a multiple of 64 and --small-steps of 4")
    device, kind = _device(args.device)
    result = bench_window(args.n, args.steps, device)
    result.update(bench_small(args.small_steps, device))
    result["m1"] = bench_1m(args.m1_n, M1_STEPS, device)
    ps = result.pop("ps_per_s")
    out = {
        "metric": "particle_steps_per_s",
        "value": ps,
        "unit": "particle-steps/s",
        "vs_baseline": ps / BASELINE_PS,
        **result,
        "backend": "window",
        "device": kind,
        "not_ported": ["dd", "dd_strong"],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
