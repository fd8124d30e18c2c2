"""Throughput and device-time breakdown of the stepper (counterpart of
`pi_sph_fluid_tpu/utils/profiling.py`: the reference's ticks/s meter,
`pi_sph_fluid.c:680-687`, plus device tracing).

* ``pool_engine(n_target, device)``: bench.py's pool scene and a
  WindowEngine on it;
* ``throughput(multi_step, sim, g_trace, n_particles)``: median
  particle-steps/s of ``multi_step(sim, g_trace)`` over repeats, each from
  the same ``sim``, with the device synchronised around each one;
* ``device_breakdown(fn)``: one call of ``fn`` under ``torch.profiler``:
  wall time, device time per CUDA kernel, and host synchronisations.

Run as a script on the GPU, it measures the pool at 100k and 1M particles
(bench.py's operating points) at resort_every=1 and 64: the spread of
ms/tick over 5 repeats, then where the device time of a tick goes:

    python -m pi_sph_fluid_tpu_torch.utils.profiling
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

from ..config import SPHConfig
from ..models.boundary import prepare_boundary
from ..models.engine_v3 import WindowEngine
from ..models.scene import build_pool_scene

__all__ = ["pool_engine", "throughput", "device_breakdown"]

G = (0.0, -9.81)


def pool_engine(n_target: int, device, **engine_kw):
    """(WindowEngine, FluidState) of bench.py's pool at about ``n_target``
    particles: r = sqrt(6.35 / n_target) (`bench.py:57-66`)."""
    cfg = SPHConfig(r=math.sqrt(6.35 / n_target))
    fluid, braw = build_pool_scene(cfg, device)
    b, bg = prepare_boundary(braw, cfg)
    return WindowEngine(cfg, b, bg, fluid.n, device, **engine_kw), fluid


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def throughput(multi_step, sim, g_trace, n_particles: int, repeats: int = 5):
    """(particle-steps/s at the median, median s/step, sorted s/step of
    every repeat) of ``multi_step(sim, g_trace)``, after one warm-up call."""
    steps = len(g_trace)
    device = sim.packed.device
    multi_step(sim, g_trace)
    times = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        multi_step(sim, g_trace)
        _sync(device)
        times.append((time.perf_counter() - t0) / steps)
    times.sort()
    t = statistics.median(times)
    return n_particles / t, t, times


def device_breakdown(fn, device) -> dict:
    """Runs ``fn()`` once under ``torch.profiler``.  Returns the traced wall
    seconds, the device-busy seconds (self time of every CUDA kernel,
    summed), per-kernel rows ``(name, seconds, launches)`` largest first,
    and the count of ``cudaStreamSynchronize`` calls (the host waiting on
    the device: ``.item()``, ``nonzero``, boolean masks).  On the CPU the
    device rows are empty."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total * 1e-6, e.count)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    return dict(wall_s=wall, busy_s=sum(r[1] for r in rows), rows=rows,
                syncs=syncs)


def _gravity(n: int) -> np.ndarray:
    return np.tile(np.float32(G), (n, 1))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiling: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}", flush=True)
    for n_target in (100_000, 1_000_000):
        eng, fluid = pool_engine(n_target, dev)
        sim0 = eng.prime(fluid, G)
        cells = {"r1": (eng.make_multi_step(resort_every=1), 64, 16),
                 "r64": (eng.make_multi_step(resort_every=64),
                         384 if n_target < 500_000 else 64, 64)}
        spread = {}
        for name, (multi, n, _) in cells.items():
            ps, t, times = throughput(multi, sim0, _gravity(n), fluid.n)
            spread[name] = dict(ticks=n, ms_per_tick=[x * 1e3 for x in times],
                                median_ms=t * 1e3, ps_per_s_median=ps)
        print(json.dumps({"n_fluid": fluid.n, "n_layout": eng.n_layout,
                          "L": eng.spec.L, **spread}), flush=True)
        for name, (multi, _, n) in cells.items():
            b = device_breakdown(lambda: multi(sim0, _gravity(n)), dev)
            print(f"== {fluid.n} {name}: {n} ticks, traced wall "
                  f"{b['wall_s'] * 1e3 / n:.4f} ms/tick, device busy "
                  f"{b['busy_s'] * 1e3 / n:.4f} ms/tick "
                  f"({100 * b['busy_s'] / b['wall_s']:.1f}% of wall), "
                  f"syncs/tick {b['syncs'] / n:.2f}", flush=True)
            for key, s, count in b["rows"][:14]:
                print(f"   {s * 1e3 / n:8.4f} ms/tick {100 * s / b['busy_s']:5.1f}%"
                      f"  x{count / n:5.2f}/tick  {key[:90]}", flush=True)


if __name__ == "__main__":
    main()
