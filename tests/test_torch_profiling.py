"""The port's profiling helpers on the CPU, at a tiny size: bench.py's pool
radius, the throughput meter's arithmetic, and the profiler breakdown,
which has no device rows without a card."""

import math

import numpy as np
import torch

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch.utils.profiling import (device_breakdown,
                                                    pool_engine, throughput)

torch.set_num_threads(1)

G = (0.0, -9.81)


def _drop():
    cfg = T.SPHConfig()
    fluid, braw = T.build_drop_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, "cpu", tq=32, qb=8)
    return eng, fluid, eng.prime(fluid, G)


def test_pool_engine_uses_bench_radius():
    """r = sqrt(6.35 / n_target), so the pool holds about n_target
    particles (within 5%)."""
    eng, fluid = pool_engine(2_000, "cpu", tq=32, qb=8)
    assert eng.cfg.r == math.sqrt(6.35 / 2_000)
    assert abs(fluid.n - 2_000) <= 100
    assert eng.spec.qb == 8 and fluid.x.device.type == "cpu"


def test_throughput_median_of_repeats():
    """Each repeat starts from the same state; the median s/step and the
    rate agree with the sorted per-repeat times."""
    eng, fluid, sim = _drop()
    calls = []
    multi = eng.make_multi_step(resort_every=2)

    def counted(s, g):
        calls.append(s)
        return multi(s, g)

    ps, t, times = throughput(counted, sim, np.tile(np.float32(G), (4, 1)),
                              fluid.n, repeats=3)
    assert len(calls) == 4 and all(c is sim for c in calls)   # warm-up + 3
    assert times == sorted(times) and len(times) == 3
    assert t == times[1] > 0
    assert ps == fluid.n / t


def test_device_breakdown_on_cpu_has_no_device_rows():
    eng, _, sim = _drop()
    step = eng.make_multi_step()
    out = device_breakdown(lambda: step(sim, np.tile(np.float32(G), (2, 1))),
                           "cpu")
    assert out["wall_s"] > 0
    assert out["rows"] == [] and out["busy_s"] == 0 and out["syncs"] == 0
