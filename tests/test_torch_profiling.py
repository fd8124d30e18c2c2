"""The port's profiling helpers on the CPU, at a tiny size: bench.py's pool
radius, the throughput meter's arithmetic, and the profiler breakdown,
which has no device rows without a card."""

import math

import numpy as np
import torch

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch.tools import forces_probe as fp
from pi_sph_fluid_tpu_torch.utils.profiling import (device_breakdown, pairs_in_reach,
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


def test_breakdown_counts_operator_calls_and_pair_passes_gather_nothing():
    """``ops`` counts the aten operators the host recorded.  The two window
    passes of a tick call no index_select, no index and no cat: their
    candidates are read through the relayout's spans, not gathered."""
    eng, _, sim = _drop()
    pk, ctx, _ = eng._relayout(eng._kick_drift(sim))
    out = device_breakdown(lambda: eng._pair_passes(pk, ctx, np.float32(G),
                                                    eng.half_dt, 1.0), "cpu")
    ops = out["ops"]
    assert ops.get("aten::sqrt", 0) >= 2           # both plain passes ran
    assert "aten::index_select" not in ops
    relayout = device_breakdown(lambda: eng._relayout(sim.packed), "cpu")["ops"]
    assert relayout.get("aten::index", 0) >= 2     # the relayout's row gathers


def test_launch_probe_builds_every_wrappers_call():
    """The launch probe's calls, at a small pool on the CPU: the five
    wrappers by name, the window passes returning their two outputs and
    the field one, through the plain versions (no launch counted)."""
    from pi_sph_fluid_tpu_torch.tools import launch_probe
    from pi_sph_fluid_tpu_torch.utils.tracer import tracer

    calls = launch_probe.wrapper_calls("cpu", 1_500)
    assert list(calls) == ["density_window", "forces_window", "field_window",
                           "window_copy", "span_density"]
    geo8, rp = calls["density_window"]()
    pk_next, acc = calls["forces_window"]()
    field = calls["field_window"]()
    assert geo8.shape == pk_next.shape and rp.shape == acc.shape == (geo8.shape[0], 2)
    assert field.dim() == 1 and torch.isfinite(field).all()
    assert torch.isfinite(acc).all() and (rp[:, 0] >= 0).all()
    assert (tracer.counters.get("kernel.density.launches", 0)
            == tracer.counters.get("kernel.forces.launches", 0) == 0)


def test_pairs_in_reach_counts_window_pairs_within_support():
    """pairs_in_reach over a relayout of the drop equals a direct count:
    for every block, each query row against each lane of the block's
    window (its spans laid end to end, the first cap of them), r^2 within
    (2H)^2."""
    eng, fluid, _ = _drop()
    pk, ctx, _ = eng._relayout(eng._initial_packed(fluid))
    spec, cfg = eng.spec, eng.cfg
    xy = torch.cat([pk[:, 0:2], eng._b_geo_d[:, 0:2]])
    half, want = spec.n_spans // 2, 0
    for b in range(spec.n_layout // spec.qb):
        rows = []
        for k, (s, n) in enumerate(ctx.spans[b].tolist()):
            rows += [r + (spec.n_layout if k >= half else 0) for r in range(s, s + n)]
        cand = xy[rows[:spec.cap]]
        q = pk[b * spec.qb:(b + 1) * spec.qb, 0:2]
        d = q[:, None] - cand[None]
        want += int(((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                     < (2.0 * cfg.h) ** 2).sum())
    got = pairs_in_reach(pk, eng._b_geo_d, ctx.spans, cfg, spec)
    assert got == want > 0


# what ptxas -v prints for one kernel of a library (nvcc 12.8, sm_90a)
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120density_window_kernelILi2ELi2EEEvPK6float4' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120density_window_kernelILi2ELi2EEEvPK6float4
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 8448 bytes smem, 436 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120forces_window_kernelILi4ELi2EEEvPK6float4' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120forces_window_kernelILi4ELi2EEEvPK6float4
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 45 registers, used 1 barriers, 16640 bytes smem, 476 bytes cmem[0]
"""


def test_forces_probe_reads_ptxas_and_resident_blocks():
    """The forces probe takes the forces kernel's line of ptxas's log, not
    another kernel's, and the blocks an SM holds follow the CUDA occupancy
    rules of compute capability 9.0: registers a warp in units of 256,
    shared memory in units of 128 bytes plus 1 KB a block."""
    assert fp._ptxas(PTXAS_LOG, "forces_window_kernel") == dict(
        spill_bytes=8, registers=45, smem=16640)
    assert fp._ptxas(PTXAS_LOG, "density_window_kernel")["registers"] == 30
    # 45 or 43 registers: 1,536 a warp, 42 warps, 10 blocks of 4 warps
    assert fp.resident_blocks(45, 16640, 128) == dict(
        blocks=10, warps=40, limited_by=["registers"])
    assert fp.resident_blocks(43, 16640, 128)["blocks"] == 10
    # 40 registers: 1,280 a warp, 51 warps, 12 blocks; shared memory 13
    assert fp.resident_blocks(40, 16640, 128)["blocks"] == 12
    assert fp.resident_blocks(32, 16640, 128) == dict(
        blocks=13, warps=52, limited_by=["smem"])
    assert fp.resident_blocks(16, 0, 32)["limited_by"] == ["blocks"]
