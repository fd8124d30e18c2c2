"""Headline benchmark of the port: WCSPH particle-steps per second on one
GPU (port of the repository's `bench.py`).

Runs the pool scene (settled steady state, the layout's sizing case)
through WindowEngine, free-running (REALTIME off, `pi_sph_fluid.c:10`), and
prints ONE JSON line with bench.py's keys:

* ``value``: particle-steps/s at 100k particles and resort_every=64 (the
  runtime ladder's ceiling), the median of 3 dispatches of 384 ticks, with
  ``ps_per_s_min`` / ``ps_per_s_max``; ``exact_ps_per_s`` at resort_every=1
  and ``r8_ps_per_s`` at 8 (the ladder's floor after a stale trip), each
  the median of 3 with its ``_min`` / ``_max``;
* ``stale_drift``: real particles that drifted past the 0.3*H fringe margin
  on a carried tick of the r64 and r8 runs (the drift guard; it must read 0),
  ``neighbor_overflow`` (window lanes lost to the cap; must read 0) and
  ``max_rho_error_pct``;
* ``frame_ms`` / ``render_overflow``: one 64x128 ``render_from_frame`` from
  the r64 run's last relayout frame, over 10 frames; ``frame_ms_256x128``
  the same at 256x128;
* ``smallN_ticks_per_s`` / ``smallN_vs_realtime``: the reference's own
  operating point, the 269-particle drop (`pi_sph_fluid.c:484-543`), at
  tq=32, qb=8, resort_every=4, 4096 ticks, against its enforced 4102
  ticks/s (`pi_sph_fluid.c:694-701`);
* ``m1``: the 1M-particle pool at resort_every=64, 64 ticks;
* ``dd``: the slab decomposition (parallel/domain_window.WindowDomain) as
  one slab over ``LocalComm(1)`` of the pool at 500k particles, with the
  whole DD machinery (migration, halo exchange, sticky groups, overflow by
  capacity), resort_every=64, 384 ticks after a warm-up dispatch, the
  median of 3 dispatches;
  ``dd_strong``: the same at 250k and 125k particles a slab.  Each row
  leads with ``slabs_measured: 1``: one card measures one slab, and the
  line projects nothing across cards (``scaling_across_cards``);
* ``vs_baseline``: against the reference's implied real-time throughput on
  a Raspberry Pi 4, 431 particles x 4102 ticks/s (BASELINE.md);
* ``device``: the card's name.

Not carried over: the echo of earlier TPU headlines, the projected
multi-chip figures of the DD rows, and the CPU fallback.  Without a CUDA
device the bench raises unless ``--device cpu`` is given, which runs the
same code through the kernels' plain versions (for tests, at small sizes).

    python -m pi_sph_fluid_tpu_torch.bench
    python -m pi_sph_fluid_tpu_torch.bench --device cpu --n 2000 --steps 64 --m1-n 3000 \
        --small-steps 16 --dd-n 2000
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import numpy as np
import torch

from .config import SPHConfig
from .models.boundary import prepare_boundary
from .models.engine_v3 import WindowEngine
from .models.scene import build_drop_scene, build_pool_scene
from .parallel import LocalComm, WindowDomain
from .render.metaballs_window import WindowRenderer
from .utils.profiling import pool_engine, resolve_device

__all__ = ["main", "bench_window", "bench_small", "bench_1m", "bench_dd"]

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


def _timed(multi, sim, g, device, runs: int = 1):
    """(wall seconds of each run, the last run's outputs) of ``runs`` calls
    ``multi(sim, g)``, each from the same ``sim``, after a warm-up call of
    the same length."""
    multi(sim, g)
    walls = []
    for _ in range(runs):
        _sync(device)
        t0 = time.perf_counter()
        out = multi(sim, g)
        _sync(device)
        walls.append(time.perf_counter() - t0)
    return walls, out


def _rates(n: int, steps: int, walls: list, key: str) -> dict:
    """particle-steps/s at the median wall under ``key``, and at the
    slowest and the fastest run under ``key_min`` / ``key_max``."""
    return {key: n * steps / statistics.median(walls),
            f"{key}_min": n * steps / max(walls), f"{key}_max": n * steps / min(walls)}


def _frame_ms(eng, sim, frame, rows: int, cols: int, device) -> tuple:
    """(ms a frame of ``render_from_frame`` over N_FRAMES after a warm-up,
    the render overflow)."""
    rend = WindowRenderer(eng, rows, cols)
    rend.render_from_frame(sim, frame)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(N_FRAMES):
        _, f_ov = rend.render_from_frame(sim, frame)
    _sync(device)
    return (time.perf_counter() - t0) / N_FRAMES * 1e3, int(f_ov)


def bench_window(n: int, steps: int, device: torch.device) -> dict:
    """The pool at about ``n`` particles: r64, r8 and r1 (each the median
    of 3 with min and max), and the 64x128 and 256x128 frames from the r64
    run's frame."""
    eng, fluid = pool_engine(n, device)
    sim = eng.prime(fluid, G)
    g = _gravity(steps)
    walls, (sim64, st64, frame) = _timed(
        eng.make_multi_step(resort_every=RESORT, return_frame=True), sim, g, device, 3)
    rates = _rates(fluid.n, steps, walls, "ps_per_s")
    walls8, (_, st8) = _timed(eng.make_multi_step(resort_every=8), sim, g, device, 3)
    rates.update(_rates(fluid.n, steps, walls8, "r8_ps_per_s"))
    walls1, _ = _timed(eng.make_multi_step(resort_every=1), sim, g, device, 3)
    rates.update(_rates(fluid.n, steps, walls1, "exact_ps_per_s"))
    frame_ms, f_ov = _frame_ms(eng, sim64, frame, 64, 128, device)
    frame_ms_big, f_ov_big = _frame_ms(eng, sim64, frame, 256, 128, device)
    return {
        "n_fluid": fluid.n,
        "steps": steps,
        "wall_s": statistics.median(walls),
        **rates,
        "resort_every": RESORT,
        "stale_drift": int(st64.stale.sum()) + int(st8.stale.sum()),
        "scene": "pool",
        "max_rho_error_pct": float(st64.max_rho_error_pct.max()),
        "neighbor_overflow": int(st64.neighbor_overflow.max()),
        "frame_ms": frame_ms,
        "frame_ms_256x128": frame_ms_big,
        "render_overflow": f_ov + f_ov_big,
    }


def bench_small(steps: int, device: torch.device) -> dict:
    """The reference's operating point: the 269-particle drop at tq=32,
    qb=8, cap=256, resort_every=4 (`bench.py:101-112`)."""
    cfg = SPHConfig()
    fluid, braw = build_drop_scene(cfg, device)
    b, bg = prepare_boundary(braw, cfg)
    eng = WindowEngine(cfg, b, bg, fluid.n, device, tq=32, qb=8, cap=256, seg_q=2)
    (wall,), _ = _timed(eng.make_multi_step(resort_every=4), eng.prime(fluid, G),
                        _gravity(steps), device)
    return {"smallN_ticks_per_s": steps / wall,
            "smallN_vs_realtime": steps / wall / REALTIME_TICKS}


def bench_1m(n: int, steps: int, device: torch.device) -> dict:
    """The 1M-particle north-star operating point (BASELINE.md: 1M at 60+
    steps/s), at resort_every=64."""
    eng, fluid = pool_engine(n, device)
    (wall,), (_, st) = _timed(eng.make_multi_step(resort_every=RESORT),
                              eng.prime(fluid, G), _gravity(steps), device)
    return {
        "n_fluid": fluid.n,
        "ps_per_s": fluid.n * steps / wall,
        "steps_per_s": steps / wall,
        "ms_per_step": wall / steps * 1e3,
        "stale_drift": int(st.stale.sum()),
        "neighbor_overflow": int(st.neighbor_overflow.max()),
    }


def bench_dd(per_slab_n: int, steps: int, device: torch.device) -> dict:
    """One slab of the pool at about ``per_slab_n`` particles as a
    ``WindowDomain`` over ``LocalComm(1)`` (`bench.py:172-229`): the whole
    DD machinery on one card, at resort_every=64, the median of 3
    dispatches of ``steps`` ticks after a warm-up one.  Its stats carry
    their own drift guard (``stale_drift``, which must read 0) and overflow
    (every capacity, which must read 0)."""
    cfg = SPHConfig(r=math.sqrt(6.35 / per_slab_n))
    fluid, braw = build_pool_scene(cfg, device)
    b, bg = prepare_boundary(braw, cfg)
    dd = WindowDomain(cfg, b, bg, fluid.n, LocalComm(1), device)
    walls, (_, st) = _timed(dd.make_multi_step(resort_every=RESORT),
                            dd.init(fluid), _gravity(steps), device, 3)
    wall = statistics.median(walls)
    return {
        "slabs_measured": 1,
        "n_fluid_per_slab": fluid.n,
        "ps_per_s_per_slab": fluid.n * steps / wall,
        "ms_per_step": wall / steps * 1e3,
        "resort_every": RESORT,
        "overflow": int(st["overflow"].max()),
        "stale_drift": int(st["stale"].sum()),
        "scaling_across_cards": "not measured: one card runs one slab",
    }


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
    ap.add_argument("--dd-n", type=int, default=500_000,
                    help="dd: pool particles a slab (dd_strong: a half and a "
                         "quarter of it)")
    args = ap.parse_args(argv)
    if args.steps % RESORT or args.small_steps % 4:
        raise SystemExit("--steps must be a multiple of 64 and --small-steps of 4")
    device, kind = resolve_device(args.device, "bench")
    result = bench_window(args.n, args.steps, device)
    result.update(bench_small(args.small_steps, device))
    result["m1"] = bench_1m(args.m1_n, M1_STEPS, device)
    result["dd"] = bench_dd(args.dd_n, args.steps, device)
    result["dd_strong"] = {f"slab_{n}": bench_dd(n, args.steps, device)
                           for n in (args.dd_n // 2, args.dd_n // 4)}
    ps = result.pop("ps_per_s")
    out = {
        "metric": "particle_steps_per_s",
        "value": ps,
        "unit": "particle-steps/s",
        "vs_baseline": ps / BASELINE_PS,
        **result,
        "backend": "window",
        "device": kind,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
