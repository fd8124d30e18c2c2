#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pi_sph_fluid_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line with its seconds:

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build: nvcc compiles the window kernels (density, forces, field), the
   probe kernels (window copy, span density) and the relayout kernels
   from the checkout's sources, one nvcc per source, all started together, with ptxas's
   registers and spills for each;
3. kernels against their plain PyTorch versions on one relayout of the
   100k pool (density and forces through the relayout's span table, at the
   default cap and again at cap=1024, the live run's, on the pool squeezed
   until a window spans several staged chunks; the field kernel
   through the renderer's inputs for the same relayout, the packed state,
   the start grid and the static index pairs, at 64x128), with times for
   both, each kernel's window lanes (sum of min(w_len, cap), for the field
   kernel the fluid lanes alone, and the distinct candidate rows they
   touch) and its bound on this card; then the host
   microseconds per launch of each of the five wrappers (launch_host);
   then the relayout kernels against the plain chain at 100k and 1M
   (relayout: every output bitwise, CUDA-event ms, device ms and device
   operations a relayout of each, the kernels' host us, bytes and the
   bound);
4. the 100k pool (bench.py's operating point) through WindowEngine: prime,
   64 ticks at resort_every=1, 384 ticks at resort_every=64; the launch
   counters must grow by exactly one per tick; the plain path's ms/tick on
   a short run beside the kernel path's; and a profiler check that the 62
   more carried ticks of a 64-tick sticky group over a 2-tick one add no
   host sync, no ``index_select``, no ``index`` and no ``cat``; that a
   rendered frame launches no ``index_select`` and no ``cat`` and costs the
   host no wait, and that a relayout on the card runs no ``cummax``, no
   ``bincount`` and no ``nonzero``, never waits for the host (the sync
   debug mode and the profiler) and launches at most 20 kernels, the
   sort's included;
5. dd: the same 100k pool as a slab decomposition (parallel/domain_window
   .WindowDomain) of 1, 2 and 4 slabs under LocalComm: 15 exact steps
   from zeroed accelerations against the single engine started the same
   way, exactly d density and d forces launches a step, no overflow in
   any column; one slab of the 4-slab run's relayout through both kernels
   against their plain versions; ms/step (CUDA events, median of 5 runs)
   beside the single engine's, and host syncs a step by the profiler; the
   3k C golden through 4 slabs to step 200 at the JAX DD gate;
   dd_sticky: the same pool as 1 and 4 slabs in sticky groups of 4 for 16
   ticks, against the same domain at r1 and against the single engine at
   r4, exactly d density and d forces launches a tick, stale 0; one slab's
   carried tick through both kernels against their plain versions; ms/tick
   at r4 and r64, and a carried tick's host syncs, launches and device ms;
   dd_render: the 4-slab state's per-slab frames at 64x128 and 256x128,
   exactly 4 field launches a frame, the frame against
   ``WindowRenderer.render`` on the gathered state, slab 1's field kernel
   against its plain version, ms, launches and syncs a frame;
   dd_multiprocess: the same pool as 4 slabs over two processes on this
   card (the worker, pi_sph_fluid_tpu_torch/tools/multihost_worker.py,
   here started as ``chip_smoke.py --dd-worker``; gloo through a file
   store, every exchanged buffer staged through host memory): one exact
   step, 64 sticky ticks at r64 and one 64x128 frame, whose export and
   frame must equal the same sequence over LocalComm(4) in this process
   bitwise; per process 2 density and 2 forces launches a tick and 2 field
   launches a frame, ms a tick at r64 beside the in-process run's, a
   carried tick's host syncs, launches and staged bytes, its peak device
   memory, and its first slab's carried tick and frame through the three
   kernels against their plain versions;
6. the 3k-particle C golden drop, all 2000 steps through the kernels;
7. the 1M pool: 64 ticks at resort_every=64, after one warm-up group;
8. render: render_from_frame ms per frame at 64x128 and 256x128 on the
   100k and 1M pools' last relayout frames (CUDA events, 20 frames after
   one warm-up), render overflow 0;
9. golden_render: WindowRenderer.render through the field kernel on the C
   golden positions (269 drop and 3k drop) against the C framebuffers;
10. runner, the live path a user runs: ``cli run`` on the 100k pool with a
   file display, about 30 dispatches of one 60 Hz frame each: one frame
   written and one field launch per dispatch, no recovery, overflow and
   stale 0, the floor row lit in every frame, the launch counters set to
   0 just before and read just after, and the relayout counter equal to
   the run's ``stepper.relayout`` spans and above 0 (every relayout of the
   run went down the relayout kernels); then ``cli bench`` on the 1M pool
   with rendering;
11. runner_recovery: ``cli run`` on the 100k pool at the CLI defaults,
   where the startup jets overflow the cap: at least one recovery, one
   field launch per dispatch run (replays included), one frame written per
   dispatch less the one each revert drops, overflow and stale 0 at the end,
   the relayouts counted as in runner;
   runner_dd: ``cli run --backend window-dd --slabs 4`` on the dam at the
   CLI defaults with a file display: 4 field launches a dispatch run, one
   frame a dispatch less one a revert, overflow and stale 0 at the end,
   the relayouts counted as in runner;
   runner_dd_mp: the same command as two processes on this card
   (``--num-processes 2 --dist-backend gloo``): process 0's frame file
   byte-equal to runner_dd's and its recovery lines the same, process 1
   writing no frame and printing nothing on its standard output;
12. probes: the two probe scripts as a user runs them (``python -m
   pi_sph_fluid_tpu_torch.tools.unaligned_probe`` / ``.span_dma_probe``,
   their ``main()`` with the launch counters set to 0 just before and read
   just after), then each probe kernel against its plain version at every
   shape and form the scripts run (the copy bitwise, the span within rtol
   1e-5 of max |out|), with CUDA-event ms, the plain version's ms, the
   profiler's device time, bytes, FLOPs and the bound, the copy's library
   call (``src[:, idx]``) by events and by device time, and the
   aligned/unaligned, B/A and C/A ratios;
13. bench: ``python -m pi_sph_fluid_tpu_torch.bench`` in a subprocess at its
   defaults; its JSON line must show overflow, stale and render overflow 0,
   and its ``dd`` and ``dd_strong`` rows one slab each, overflow and stale
   0, scaling across cards not measured;
14. oracle: the reference backend on the card: the 269 drop through step
   500 against the C golden at test_parity.py's gates, with no window
   kernel launched, then ``cli run --backend reference`` with a file
   display, frames written;
15. tools: the tools of pi_sph_fluid_tpu_torch/tools/ through their
   ``main()`` at full width with cut lengths, the launch counters set to 0
   just before and read just after: render_probe on the 1M pool at 64x128
   (both overflow counts 0), dd_probe on the 100k pool (overflow 0 and
   every particle valid at r1, r4, r8), dynamic_stale_probe on the 100k dam
   in both backends (512 ticks at r4 to r64 after a shorter settle and one
   pre-roll dispatch; stale and overflow 0), cfl_probe on the 100k pool
   (one 0.1 sim-s report, overflow and stale 0, under 40 m/s), and
   frames_to_gif on the runner phase's own capture, its GIF decoded here
   frame by frame and equal to the capture; the relayouts counted as in
   runner;
16. divergence: from one state, 1024 ticks at resort_every 1, 8 and 64
   and at 1 from every fluid x one ulp up (the chaos control), by id every
   128 ticks (max |dx, dy|, max |du, dv|, max relative d rho against r1,
   summed stale counts), on the 100k pool primed at cap 1024 (no stale tick
   and no overflow allowed in any run) and on the 100k dam after
   dynamic_stale_probe's settle and pre-roll at its defaults; at the end
   of every r64 group, the stalest tick, the state's density against the
   jnp oracle's (models/simulation.prime) on the same fluid, within 1e-5
   relative.

Then one JSON line that holds every kernel's results, the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``.  Any failure raises and
the exit code is nonzero; without a CUDA device the script fails before
any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import pi_sph_fluid_tpu_torch as T  # noqa: E402
from pi_sph_fluid_tpu_torch import cli  # noqa: E402
from pi_sph_fluid_tpu_torch.models import engine_v3  # noqa: E402
from pi_sph_fluid_tpu_torch.ops.window import _build  # noqa: E402
from pi_sph_fluid_tpu_torch.ops.window import relayout  # noqa: E402
from pi_sph_fluid_tpu_torch.ops.window import window_kernels as wk  # noqa: E402
from pi_sph_fluid_tpu_torch.models import simulation  # noqa: E402
from pi_sph_fluid_tpu_torch.parallel import LocalComm, WindowDomain  # noqa: E402
from pi_sph_fluid_tpu_torch.parallel import domain_window  # noqa: E402
from pi_sph_fluid_tpu_torch.render import metaballs_window as mw  # noqa: E402
from pi_sph_fluid_tpu_torch.tools import (cfl_probe, dd_probe,  # noqa: E402
                                          dynamic_stale_probe, frames_to_gif,
                                          launch_probe, render_probe)
from pi_sph_fluid_tpu_torch.tools import multihost_worker  # noqa: E402
from pi_sph_fluid_tpu_torch.tools import span_dma_probe as sp  # noqa: E402
from pi_sph_fluid_tpu_torch.tools import unaligned_probe as up  # noqa: E402
from pi_sph_fluid_tpu_torch.utils.profiling import (bound, call_device_ms,  # noqa: E402
                                                    covered, device_breakdown,
                                                    device_memory, event_ms,
                                                    host_us, kernel_device_ms,
                                                    pairs_in_reach, pool_engine)
from pi_sph_fluid_tpu_torch.utils.tracer import tracer  # noqa: E402

G = (0.0, -9.81)
DEV = torch.device("cuda")
N_POOL = 100_000        # bench.py:57-66
N_BIG = 1_000_000       # bench.py:149-169
GOLDEN_STEPS = 2000     # the whole 3k C golden
N_WARM, N_R1, N_R64, N_PLAIN = 8, 64, 384, 16
N_FRAMES = 20           # render_from_frame timings, after one warm-up
SHAPES = ((64, 128), (256, 128))
RUN_DISPATCHES = 30     # cli run: dispatches of one 60 Hz frame each
LIVE_CAP = 1024         # the live run's cap (the runner's ceiling)
SQUEEZE = 0.6           # the pool squeezed to this: windows of several chunks
RECOVERY_DISPATCHES = 24  # cli run at the defaults: 0.4 s, past the startup jets
BENCH_TIMEOUT = 600     # seconds for the bench subprocess
ORACLE_GATES = {100: (5e-6, 5e-5), 200: (1e-5, 1e-4), 500: (1e-4, 5e-3)}
DD_SLABS = (1, 2, 4)
DD_STEPS = 15           # test_parallel_window.py:41-64
DD_TIMED_STEPS, DD_RUNS = 8, 5
DD_GOLDEN_STEPS = 200   # test_parity_3k.py:149-191
# the DD against the single engine after DD_STEPS (test_parallel_window.py:
# 60-64): |dx|, |dy| m, |du| m/s, and rho within rtol + atol
DD_GATES = dict(xy=1e-6, u=1e-5, rho_rtol=1e-5, rho_atol=1e-2)
# the DD against the 3k C golden at step 200 (test_parity_3k.py:185-191)
DD_GOLDEN_GATES = dict(xy=5e-5, uv=3e-3, rho_rel=1e-3)
# sticky groups: the 100k pool at resort_every=4 for 16 ticks, against the
# same domain at r1 (test_parallel_window.py:94-97) and against the single
# engine in the same sticky mode (:126-128)
DD_STICKY_SLABS, DD_STICKY_TICKS, DD_STICKY_R = (1, 4), 16, 4
DD_STICKY_GATES = dict(xy=1e-6, u=1e-5, single_xy=1e-5, single_u=1e-4)
DD_CARRIED = (2, 10)    # group lengths whose profiles differ by 8 carried ticks
DD_RENDER_SLABS, DD_RENDER_FRAMES = 4, 10
RUNNER_DD_SLABS, RUNNER_DD_DISPATCHES = 4, 12   # cli run --backend window-dd, the dam
# its ticks a dispatch: one 60 Hz frame, rounded up to resort_every=8
RUNNER_DD_K = -(-int(round(1.0 / (60.0 * T.SPHConfig().dt))) // 8) * 8
# the decomposition over two processes on this card: DD_MP_SLABS slabs of
# the 100k pool, half in each; one exact step, DD_MP_TICKS ticks in one
# sticky group, one frame
DD_MP_PROCS, DD_MP_SLABS, DD_MP_TICKS = 2, 4, 64
MP_TIMEOUT = 300        # seconds for a pair of processes
# the tools phase: dynamic_stale_probe cut to 512 ticks a period after a
# shorter settle and one pre-roll dispatch; cfl_probe's one factor over one
# 0.1 sim-s report after a short damped settle (4,096 + 772 ticks at 100k),
# from cap 1536: from 1024 the runner recovers once and replays it all
TOOLS_STALE_RESORTS = (4, 8, 16, 32, 64)
TOOLS_STALE_ARGS = ["--steps", "512", "--resorts", ",".join(map(str, TOOLS_STALE_RESORTS)),
                    "--settle", "256", "--preroll-s", "0.01"]
TOOLS_CFL_ARGS = ["--seconds", "0.12", "--settle", "0.02", "--factors", "1.0",
                  "--cap", "1536"]
# the divergence phase: DIV_TICKS ticks a run in groups of DIV_GROUP (one
# r64 group), compared every DIV_EVERY ticks; the runs beside r1, as
# (resort_every, every fluid x one ulp up); the certificate's gate on the
# stalest tick's density against the oracle's
DIV_TICKS, DIV_GROUP, DIV_EVERY = 1024, 64, 128
DIV_RUNS = {"r8": (8, False), "r64": (64, False), "r1_ulp": (1, True)}
CERT_RHO_REL = 1e-5
# what the runner says when it recovers or changes its sticky period
RECOVERY = ("OVERFLOW", "WINDOW OVERFLOW", "STALE DRIFT:", "RESORT LADDER")
# wrapper (with its launch counter), the TPU kernel it replaces and its source
WINDOW_SRC = "pi_sph_fluid_tpu_torch/csrc/window_kernels.cu"
PROBE_SRC = "pi_sph_fluid_tpu_torch/csrc/probe_kernels.cu"
KERNELS = {
    "density_window": (wk.density_window,
                       "pi_sph_fluid_tpu/ops/pallas/window_kernels.py:192", WINDOW_SRC),
    "forces_window": (wk.forces_window,
                      "pi_sph_fluid_tpu/ops/pallas/window_kernels.py:317", WINDOW_SRC),
    "field_window": (mw.field_window,
                     "pi_sph_fluid_tpu/render/metaballs_window.py:164", WINDOW_SRC),
    "window_copy": (up.window_copy, "tools/unaligned_probe.py:34", PROBE_SRC),
    "span_density": (sp.span_density, "tools/span_dma_probe.py:38", PROBE_SRC),
}
SIM_KERNELS = ("density_window", "forces_window", "field_window")
# the relayout's kernels, which replace no TPU kernel (ops/window/relayout.py)
RELAYOUT_SRC = "pi_sph_fluid_tpu_torch/csrc/relayout_kernels.cu"
RELAYOUT_LAUNCHES = 20  # most kernel launches a card relayout may make, the sort's included
# the runtime's kernel launch calls, as the profiler names them on the host
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# each wrapper's launch counter in utils/tracer.py's counters
COUNTER = {"density_window": "kernel.density.launches",
           "forces_window": "kernel.forces.launches",
           "field_window": "kernel.field.launches",
           "window_copy": "probe.window_copy.launches",
           "span_density": "probe.span_density.launches",
           "relayout": "kernel.relayout.launches"}
# float32 operations per pair lane (sqrt, max and select counted as one;
# far_flops where the kernel needs only dx, dy, r^2 and the compare of a lane
# out of the query's reach, whose term is 0),
# device-memory bytes per query row (inputs read, outputs written once) and
# per distinct candidate row.  Density and forces read their fluid
# candidates from arrays the query rows already count in full (the packed
# state, geo8), so only a distinct boundary row adds bytes (lane_bytes);
# the field kernel's queries are pixels, not rows of the state, so every
# distinct fluid row it touches adds the bytes it needs of it (_field_bound)
COST = {"density_window": dict(flops=16, row_bytes=32 + 32 + 8, lane_bytes=16),
        "forces_window": dict(flops=39, far_flops=6, row_bytes=32 + 32 + 8 + 32 + 8, lane_bytes=32)}
# the field kernel: operations a pair lane, bytes a distinct fluid row (x, y
# and m of the packed row: the function needs no more, though the card moves
# the row's whole 32-byte sector) and a pixel (x, y read, the field written)
FIELD_FLOPS, FIELD_ROW_BYTES, FIELD_PIXEL_BYTES = 17, 12, 8 + 4


def _phase(name: str, t0: float, **info) -> None:
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{name}] {time.perf_counter() - t0:.2f}s {fields}", flush=True)


def _sync() -> None:
    torch.cuda.synchronize(DEV)


def _reset_counts() -> None:
    for key in COUNTER.values():
        tracer.counters.pop(key, None)


def _counts() -> dict:
    return {name: tracer.counters.get(key, 0) for name, key in COUNTER.items()}


@contextlib.contextmanager
def _relayout_spans(info: dict):
    """Records the port's spans while inside, then puts the number of
    ``stepper.relayout`` spans recorded in ``info["relayout_spans"]`` and
    drops the records.  Every relayout on the card goes down the kernels,
    so a run's relayout counter must equal it, and be above 0."""
    n0 = len(tracer.spans)
    tracer.enable()
    try:
        yield
    finally:
        tracer.disable()
        info["relayout_spans"] = sum(s.name == "stepper.relayout" for s in tracer.spans[n0:])
        del tracer.spans[n0:]


def _check_relayouts(counts: dict) -> None:
    """A run's counts (``_counts`` and ``_relayout_spans``'): one relayout
    counted a ``stepper.relayout`` span, and some."""
    assert counts["relayout"] == counts["relayout_spans"] > 0, counts


def _gravity(n: int) -> np.ndarray:
    return np.tile(np.float32(G), (n, 1))


def _field_bound(spec, n_src: int, grid, span_idx) -> dict:
    """The field kernel's bound on this card for these inputs: the larger
    of its bytes (x, y and m, 12 B, of each distinct fluid row under the pixel
    blocks' spans once, 12 B a pixel, the static index pairs and the start
    grid) over the memory rate and its pair-lane operations (17 over
    qb x fluid lanes) over the float32 rate.  Lanes are sum min(sum of span
    lengths, cap) with every span resolved and clamped as the kernel does
    it (the plain version's own table); boundary lanes are not read and not
    counted."""
    start, length = wk._grid_spans(span_idx, grid, n_src)
    rows = covered(start, length, n_src)
    lanes = int(length.sum(1).clamp_max(spec.cap).sum())
    nbytes = (rows * FIELD_ROW_BYTES + spec.n_layout * FIELD_PIXEL_BYTES
              + span_idx.numel() * 4 + grid.numel() * 4)
    return dict(window_lanes=lanes, candidate_rows=rows,
                **bound(nbytes, spec.qb * lanes * FIELD_FLOPS))


def _span_bound(name: str, spec, spans, n_bnd: int, in_reach: int) -> dict:
    """The bound of a span-fed kernel (density, forces) for these inputs:
    bytes (every query row's inputs and outputs, the span table, each
    distinct boundary row once; the fluid candidates are rows of arrays
    the query rows already count) over the memory rate, against its
    pair-lane operations over the float32 rate.  Lanes are sum min(sum of
    span lengths, cap), each span clamped into its array as the kernels
    clamp it; the distinct candidate rows are counted over the spans.
    ``in_reach`` of the qb x lanes pairs (pairs_in_reach) take the
    kernel's full operation count; the others take ``far_flops`` where the
    kernel has one (forces: a lane out of reach adds exactly 0 and needs
    only the distance test), else the full count too (density computes
    every lane)."""
    c = COST[name]
    sp_ = spans.long()
    half = sp_.shape[1] // 2
    rows, total = [], 0
    for part, n_src in ((sp_[:, :half], spec.n_layout), (sp_[:, half:], n_bnd)):
        start = part[..., 0].clamp(0, n_src)
        length = torch.minimum(part[..., 1].clamp_min(0), n_src - start)
        rows.append(covered(start, length, n_src))
        total = total + length.sum(1)
    lanes = int(total.clamp_max(spec.cap).sum())
    nbytes = (spec.n_layout * c["row_bytes"] + spans.numel() * 4
              + rows[1] * c["lane_bytes"])
    pairs = spec.qb * lanes
    assert 0 < in_reach <= pairs, (in_reach, pairs)
    flops = (in_reach * c["flops"]
             + (pairs - in_reach) * c.get("far_flops", c["flops"]))
    return dict(window_lanes=lanes, candidate_rows=sum(rows),
                pairs_in_reach=in_reach, every_lane_flops=pairs * c["flops"],
                **bound(nbytes, flops))


def _device_ms(fn, name: str, n: int = 20) -> float:
    """The profiler's device ms per launch of the CUDA kernel
    ``<name>_kernel`` (utils/profiling.py::kernel_device_ms)."""
    return kernel_device_ms(fn, f"{name}_kernel", DEV, n)


def _check_state(sim, stats, what: str) -> None:
    ov = int(stats.neighbor_overflow.max())
    assert ov == 0, f"{what}: neighbor overflow {ov}"
    if stats.stale is not None:
        assert int(stats.stale.sum()) == 0, f"{what}: stale {int(stats.stale.sum())}"
    assert bool(torch.isfinite(sim.packed).all()), f"{what}: non-finite state"
    speed = float(stats.max_speed.max())
    assert speed < 40.0, f"{what}: max speed {speed} m/s breaks the C/10 bound"


def hold_physics(eng, pk, ctx, dense: bool = False) -> dict:
    """The density and the forces kernel against their plain versions on
    one relayout ``(pk, ctx)`` of ``eng`` (compare_physics has the
    tolerances; ``dense`` widens the absolute tolerance of acc to 1e-6 of
    max |acc|, for states whose pressures cancel in the sum).  Raises on a
    disagreement; returns the kernels' arguments and the largest
    differences."""
    cfg, spec = eng.cfg, eng.spec
    assert torch.equal(ctx.spans[:, :, 1].sum(1), ctx.w_len.reshape(-1)), \
        "span lengths do not sum to w_len"
    d_args = (pk, eng._b_geo_d, ctx.spans, cfg, spec)
    g8k, rpk = wk.density_window(*d_args)
    g8p, rpp = wk.density_window_plain(*d_args)
    _sync()
    rho_k, rho_p = rpk[:, 0].double(), rpp[:, 0].double()
    rel_rho = float(((rho_k - rho_p).abs() / rho_p.abs().clamp_min(1e-30)).max())
    assert rel_rho <= 1e-6, f"density: max rel d_rho {rel_rho}"
    p_cond = 7.0 * cfg.tait_b * (rho_p / cfg.rho_0) ** 7 * 1e-6
    dp = (rpk[:, 1].double() - rpp[:, 1].double()).abs()
    assert bool((dp <= 0.05 + 1e-4 * rpp[:, 1].double().abs() + p_cond).all()), \
        f"density: max |d_p| {float(dp.max())}"
    assert torch.equal(g8k[:, [0, 1, 2, 3, 4, 7]], g8p[:, [0, 1, 2, 3, 4, 7]])

    f_args = (pk, g8p, rpp, eng._b_geo_f, ctx.spans, G, cfg, spec,
              eng.half_dt, 0.97)
    pkk, acck = wk.forces_window(*f_args)
    pkp, accp = wk.forces_window_plain(*f_args)
    _sync()
    dacc = (acck - accp).abs()
    atol = max(2e-4, 1e-6 * float(accp.abs().max())) if dense else 2e-4
    assert bool((dacc <= atol + 2e-5 * accp.abs()).all()), \
        f"forces: max |d_acc| {float(dacc.max())}"
    uv_k, uv_p = pkk[:, 2:4], pkp[:, 2:4]
    uv_bound = (eng.half_dt * (atol + 2e-5 * accp.abs())
                + 2 * torch.finfo(torch.float32).eps * uv_p.abs())
    duv = (uv_k - uv_p).abs()
    assert bool((duv <= uv_bound).all()), f"forces: max |d_uv| {float(duv.max())}"
    assert torch.equal(pkk[:, [0, 1, 4, 5, 6, 7]], pkp[:, [0, 1, 4, 5, 6, 7]]), \
        "forces: a copied pk_next column differs"
    pk0, _ = wk.forces_window(pk, g8p, rpp, eng._b_geo_f, ctx.spans, G, cfg,
                              spec, 0.0, 1.0)
    assert torch.equal(pk0[:, 2:4], pk[:, 2:4]), "priming pass moved u, v"

    return dict(d_args=d_args, f_args=f_args, rel_rho=rel_rho,
                d_rho=float((rho_k - rho_p).abs().max()), d_p=float(dp.max()),
                d_acc=float(dacc.max()), d_uv=float(duv.max()))


def compare_physics(eng, fluid, squeeze: float = 1.0) -> dict:
    """The density and the forces kernel against their plain versions on one
    relayout of the pool, through the relayout's span table, with seeded
    random velocities (N(0, 0.5) m/s) so that the viscosity term is live,
    and a nonzero half-kick and damping so that the fused epilogue is too.
    Tolerances (tests/test_torch_window.py): rho rtol 1e-6; p rtol 1e-4 /
    atol 0.05 plus rho's tolerance carried through the Tait power; acc rtol
    2e-5 / atol 2e-4; u' and v' within half_dt times the acc bound plus 2
    ulp; every copied column bitwise.  The sums run in another order (lanes
    strided over a group of threads and a shuffle tree against torch's
    reduction) and nvcc contracts a*b + c into FMAs; nothing else differs.
    ``squeeze`` < 1 scales the pool's x and y toward the corner, so that
    the windows grow past one staged chunk; the pressures of such a state
    are ~1e4 times the settled pool's and cancel in the sum, so there the
    absolute tolerance of acc is 1e-6 of max |acc|.
    Returns {kernel: its numbers} and the relayout for the field kernel."""
    cfg, spec = eng.cfg, eng.spec
    rng = np.random.default_rng(3)
    fluid = fluid._replace(x=fluid.x * squeeze, y=fluid.y * squeeze, **{
        k: torch.from_numpy(rng.normal(0.0, 0.5, fluid.n).astype(np.float32)).to(DEV)
        for k in ("u", "v")})
    pk, ctx, ov = eng._relayout(eng._initial_packed(fluid))
    assert int(ov) == 0, f"relayout overflow {int(ov)}"
    n_bnd = eng._b_geo_d.shape[0]
    in_reach = pairs_in_reach(pk, eng._b_geo_d, ctx.spans, cfg, spec)
    h = hold_physics(eng, pk, ctx, dense=squeeze != 1.0)
    d_args, f_args = h["d_args"], h["f_args"]
    out = {
        "density_window": dict(
            max_abs_err=h["d_rho"],
            ms=event_ms(lambda: wk.density_window(*d_args), 50),
            plain_ms=event_ms(lambda: wk.density_window_plain(*d_args), 5),
            device_ms=_device_ms(lambda: wk.density_window(*d_args), "density_window"),
            **_span_bound("density_window", spec, ctx.spans, n_bnd, in_reach)),
        "forces_window": dict(
            max_abs_err=h["d_acc"],
            ms=event_ms(lambda: wk.forces_window(*f_args), 50),
            plain_ms=event_ms(lambda: wk.forces_window_plain(*f_args), 5),
            device_ms=_device_ms(lambda: wk.forces_window(*f_args), "forces_window"),
            **_span_bound("forces_window", spec, ctx.spans, n_bnd, in_reach))}
    print(f"  cap {spec.cap} windows: mean {float(ctx.w_len.float().mean()):.1f} lanes, "
          f"longest {int(ctx.w_len.max())}", flush=True)
    print(f"  cap {spec.cap} density: max rel d_rho {h['rel_rho']:.3e}, "
          f"max |d_p| {h['d_p']:.3e} Pa; forces: max |d_acc| "
          f"{h['d_acc']:.3e} m/s^2, max |d_uv| {h['d_uv']:.3e} m/s", flush=True)
    for name, r in out.items():
        print(f"  cap {spec.cap} {name}: kernel {r['ms']:.4f} ms, device "
              f"{r['device_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
              f"sum min(w_len, cap) {r['window_lanes']} lanes, "
              f"{r['candidate_rows']} distinct candidate rows, "
              f"{r['pairs_in_reach']} of {spec.qb * r['window_lanes']} pairs in "
              f"reach, {r['bytes']} B, {r['flops']} FLOP ({r['every_lane_flops']} "
              f"at the full count on every lane): bound {r['bound_ms']:.6f} ms "
              f"by {r['bound_by']}", flush=True)
    return out, (pk, ctx)


def compare_kernels(eng, fluid, results: dict) -> None:
    """Each kernel against its plain version on one relayout of the pool:
    density and forces (compare_physics) at the engine's cap and again at
    cap=1024, the live run's, on the pool squeezed to 0.6 of its width and
    height, as dense as the live run's collapse, where a window spans
    several staged chunks; then the field kernel over the renderer's inputs
    for the same relayout at 64x128: the packed state, the relayout's start
    grid and the renderer's static index pairs (scaled field within rtol
    1e-5 / atol 5e-5, lit pixels identical away from the threshold)."""
    cfg = eng.cfg
    physics, (pk, ctx) = compare_physics(eng, fluid)
    for name, r in physics.items():
        results[name].update(r)
    dense, (_, dense_ctx) = compare_physics(
        pool_engine(N_POOL, DEV, cap=LIVE_CAP)[0], fluid, SQUEEZE)
    assert int(dense_ctx.w_len.max()) > 256, int(dense_ctx.w_len.max())   # > one chunk
    for name, r in dense.items():
        results[name]["cap1024"] = r

    rend = mw.WindowRenderer(eng, *SHAPES[0])
    rspec = rend.reuse_spec
    _, wl_r, ov_r = mw.pixel_windows(ctx.T, rend.c_first, rend.c_last, rend.has_q,
                                     rspec.cap, cfg.n_cells)
    assert int(ov_r) == 0, f"render overflow {int(ov_r)}"
    r_args = (rend.q_packed, pk, ctx.start_grid, rend.reuse_span_idx, cfg, rspec)
    fk = mw.field_window(*r_args) * rend.field_scale
    fp = mw.field_window_plain(*r_args) * rend.field_scale
    _sync()
    dfield = (fk - fp).abs()
    assert bool((dfield <= 5e-5 + 1e-5 * fp.abs()).all()), \
        f"field: max |d_field| {float(dfield.max())}"
    confident = (fp - 1.0).abs() > 1e-3
    assert torch.equal((fk >= 1.0)[confident], (fp >= 1.0)[confident]), \
        "field: a lit pixel away from the threshold differs"
    r = results["field_window"]
    r.update(
        max_abs_err=float(dfield.max()),
        ms=event_ms(lambda: mw.field_window(*r_args), 50),
        plain_ms=event_ms(lambda: mw.field_window_plain(*r_args), 5),
        device_ms=_device_ms(lambda: mw.field_window(*r_args), "field_window"),
        **_field_bound(rspec, pk.shape[0], ctx.start_grid, rend.reuse_span_idx))
    assert r["window_lanes"] <= int(wl_r.sum()), (r["window_lanes"], int(wl_r.sum()))
    print(f"  field (64x128, cap {rspec.cap}): max |d_field| {float(dfield.max()):.3e}; "
          f"kernel {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms; {r['window_lanes']} fluid lanes of the "
          f"windows' {int(wl_r.sum())}, "
          f"{r['candidate_rows']} distinct fluid rows, {r['bytes']} B, "
          f"{r['flops']} FLOP: bound {r['bound_ms']:.6f} ms by {r['bound_by']}",
          flush=True)


def run_pool(eng, fluid) -> dict:
    """The main path: prime, warm-up ticks, N_R1 exact ticks and N_R64
    sticky ticks (each from the primed state, as bench.py runs them), with
    the launch counters checked per tick."""
    _reset_counts()
    sim0 = eng.prime(fluid, G)
    step = eng.make_multi_step(resort_every=1)
    sticky = eng.make_multi_step(resort_every=64, return_frame=True)
    step(sim0, _gravity(N_WARM))
    out = {}
    for name, multi, n in (("r1", step, N_R1), ("r64", sticky, N_R64)):
        _sync()
        t0 = time.perf_counter()
        sim, st, *frame = multi(sim0, _gravity(n))
        _sync()
        wall = time.perf_counter() - t0
        _check_state(sim, st, name)
        out[f"{name}_ps_per_s"] = fluid.n * n / wall
        out[f"{name}_ms_per_tick"] = wall / n * 1e3
    counts = _counts()
    ticks = 1 + N_WARM + N_R1 + N_R64
    assert counts["density_window"] == counts["forces_window"] == ticks, \
        f"launch counts {counts}, expected {ticks} each (one per tick)"
    assert counts["field_window"] == 0, counts
    out["launches"] = counts
    out["last"] = (sim, frame[0])     # the r64 run's state and its frame
    # the same ticks through the plain versions, for comparison only
    with mock.patch.object(engine_v3, "density_window", wk.density_window_plain), \
            mock.patch.object(engine_v3, "forces_window", wk.forces_window_plain):
        step(sim0, _gravity(1))
        _sync()
        t0 = time.perf_counter()
        step(sim0, _gravity(N_PLAIN))
        _sync()
        out["plain_r1_ms_per_tick"] = (time.perf_counter() - t0) / N_PLAIN * 1e3
    out.update(check_carried_ticks(eng, sim0))
    out.update(check_frame_ops(eng, *out["last"]))
    return out


def check_carried_ticks(eng, sim0) -> dict:
    """A carried tick of a sticky group must cost the host no wait and the
    device no row gather: a 64-tick group and a 2-tick group hold one
    relayout each, so whatever the profiler counts more of in the first
    belongs to its 62 more carried ticks.  Counted on the host side, where
    the trace is complete: ``cudaStreamSynchronize`` calls and the calls of
    ``aten::index_select``, ``aten::index`` and ``aten::cat``; and no
    ``index_select`` kernel may show in the device trace of either group."""
    counts = {}
    for k in (2, 64):
        multi = eng.make_multi_step(resort_every=k)
        multi(sim0, _gravity(k))
        b = device_breakdown(lambda: multi(sim0, _gravity(k)), DEV)
        counts[k] = dict(syncs=b["syncs"], **{
            op: b["ops"].get(f"aten::{op}", 0) for op in ("index_select", "index", "cat")})
        # on the device side no relayout launches an index_select either, so
        # the whole group must show none (the device trace may drop launches,
        # the host-side counts above may not)
        gathers = [key for key, _, _ in b["rows"]
                   if "index_select" in key or "indexSelect" in key]
        assert not gathers, gathers
    extra = {f"carried_{key}_per_tick": (counts[64][key] - counts[2][key]) / 62
             for key in counts[2]}
    assert all(v == 0 for v in extra.values()), (extra, counts)
    return dict(extra, index_select_kernels=0, group_of_2=json.dumps(counts[2]))


def check_frame_ops(eng, sim, frame) -> dict:
    """A rendered frame prepares no candidates: by the profiler's host-side
    counts, N_FRAMES calls of ``render_from_frame`` launch no
    ``index_select`` and no ``cat`` and wait for the device not once; and a
    relayout on the card runs the relayout kernels (check_relayout_ops)."""
    rend = mw.WindowRenderer(eng, *SHAPES[0])
    rend.render_from_frame(sim, frame)
    b = device_breakdown(lambda: [rend.render_from_frame(sim, frame)
                                  for _ in range(N_FRAMES)], DEV)
    frame_ops = dict(syncs=b["syncs"], **{
        op: b["ops"].get(f"aten::{op}", 0) for op in ("index_select", "cat", "cummax")})
    assert all(v == 0 for v in frame_ops.values()), frame_ops
    fields = [cnt for key, _, cnt in b["rows"] if "field_window_kernel" in key]
    assert fields and sum(fields) <= N_FRAMES, b["rows"][:6]
    ops = check_relayout_ops(eng, sim.packed)
    return dict(frame_index_select=0, frame_cat=0, frame_syncs=0,
                frame_launches=sum(r[2] for r in b["rows"]) / N_FRAMES,
                **{f"relayout_{k}": v for k, v in ops.items()})


def check_relayout_ops(eng, packed) -> dict:
    """One relayout on the card runs no ``cummax`` (nor ``bincount``, nor
    ``nonzero``, which boolean-mask indexing runs), waits for the host not once (the
    sync debug mode raises on any synchronising call, and the profiler
    counts no runtime synchronisation) and launches at most
    RELAYOUT_LAUNCHES kernels, the sort's included (the runtime's launch
    calls, counted on the host, where the trace is complete)."""
    eng._relayout(packed)
    _sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._relayout(packed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    _sync()
    with torch.profiler.profile(activities=acts) as prof:
        eng._relayout(packed)
        _sync()
    events = {e.key: e.count for e in prof.key_averages()}
    out = dict(
        cummax=events.get("aten::cummax", 0) + events.get("aten::_cummax_helper", 0),
        bincount=events.get("aten::bincount", 0),
        nonzero=events.get("aten::nonzero", 0),
        # the host waiting on the stream (.item(), nonzero, a boolean mask);
        # the device-wide wait of _sync above is not the relayout's
        syncs=sum(events.get(k, 0) for k in ("cudaStreamSynchronize",
                                              "cudaEventSynchronize")),
        launches=sum(n for k, n in events.items() if k in LAUNCH_CALLS))
    assert out["cummax"] == out["bincount"] == out["nonzero"] == out["syncs"] == 0, out
    assert 1 <= out["launches"] <= RELAYOUT_LAUNCHES, out
    return out


def _relayout_bytes(eng) -> int:
    """What a relayout must move at least: each input once (the packed
    state, the boundary CSR and start grid, the inert row) and each output
    once (the new state, order, layout_src, the start grid, T, the windows,
    the span table and the overflow)."""
    cfg, spec = eng.cfg, eng.spec
    n, grid = spec.n_layout, cfg.n_cell_rows * (cfg.n_cell_cols + 1)
    blocks = n // spec.qb
    inputs = n * 32 + (cfg.n_cells + 1) * 4 + grid * 4 + 32
    outputs = (n * (32 + 8 + 4) + grid * 4 + (cfg.n_cells + 1) * 32
               + blocks * (8 + spec.n_spans * 8) + 4)
    return inputs + outputs


def run_relayout(results: dict) -> dict:
    """The relayout kernels against the plain chain (ops/window/relayout.py)
    at 100k and 1M particles, from a primed pool kicked and drifted one
    tick (a layout-order state, as every relayout of a run gets): every
    output bitwise equal; CUDA-event ms of each, the profiler's device ms
    and device operations (kernels, memsets and copies) a relayout of each,
    the kernels' host us a relayout, bytes and the bound.  The 1M row is
    the one results keep."""
    out = {}
    for label, n_target in (("100k", N_POOL), ("1M", N_BIG)):
        eng, fluid = pool_engine(n_target, DEV)
        pk = eng._kick_drift(eng.prime(fluid, G))
        fixed = (eng.spec, eng.cfg, pk, eng.b_cell_starts, eng._b_grid, eng._inert_row)
        got, want = eng._relayout_order(pk), relayout.relayout_plain(*fixed)
        _sync()
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), label
        assert torch.equal(got[3], want[3]) and torch.equal(got[2], want[2]), label
        for f in want[1]._fields:
            assert torch.equal(getattr(got[1], f), getattr(want[1], f)), (label, f)
        kernel = device_breakdown(lambda: [eng._relayout(pk) for _ in range(10)], DEV)
        plain = device_breakdown(lambda: [relayout.relayout_plain(*fixed)
                                          for _ in range(3)], DEV)
        r = dict(n_fluid=fluid.n, n_layout=eng.n_layout,
                 ms=event_ms(lambda: eng._relayout(pk), 20),
                 device_ms=kernel["busy_s"] * 1e3 / 10,
                 device_ops=sum(c for _, _, c in kernel["rows"]) / 10,
                 host_us=min(host_us(lambda: eng._relayout(pk), 40) for _ in range(3)),
                 plain_ms=event_ms(lambda: relayout.relayout_plain(*fixed), 3),
                 plain_device_ms=plain["busy_s"] * 1e3 / 3,
                 plain_device_ops=sum(c for _, _, c in plain["rows"]) / 3,
                 plain_syncs=plain["syncs"] / 3,
                 kernels=json.dumps({k[:48]: round(t * 1e3 / 10, 5)
                                     for k, t, _ in kernel["rows"]}),
                 **bound(_relayout_bytes(eng), 0))
        out[label] = r
        print(f"  relayout {label} ({fluid.n} fluid, {eng.n_layout} slots): kernels "
              f"{r['ms']:.4f} ms by events, device {r['device_ms']:.4f} ms in "
              f"{r['device_ops']:.1f} operations, host {r['host_us']:.1f} us; plain "
              f"{r['plain_ms']:.4f} ms, device {r['plain_device_ms']:.4f} ms in "
              f"{r['plain_device_ops']:.1f} operations, {r['plain_syncs']:.1f} syncs; "
              f"{r['bytes']} B: bound {r['bound_ms']:.6f} ms; {r['kernels']}",
              flush=True)
        del eng, fluid, pk, got, want
    results["relayout"].update(out["1M"], at_100k=out["100k"])
    return {f"{label}_{k}": v for label, r in out.items()
            for k, v in r.items() if k != "kernels"}


def _median_ms(fn, n_steps: int, runs: int = DD_RUNS) -> tuple:
    """(median, every run) of the ms a step of ``fn()``, a call of
    ``n_steps`` steps, by CUDA events around each call, after one
    warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n_steps)
    return statistics.median(times), times


def _dd_errors(got, want) -> dict:
    """The largest differences of two FluidStates in id order."""
    d = {f: float((getattr(got, f) - getattr(want, f)).abs().max()) for f in "xyuv"}
    d["rho_excess"] = float(((got.rho - want.rho).abs()
                             - DD_GATES["rho_rtol"] * want.rho.abs()).max())
    return d


def run_dd(results: dict) -> dict:
    """The 100k pool as a slab decomposition of 1, 2 and 4 slabs on this
    card, each against the single engine started the same way (primed, then
    its accelerations zeroed, as a domain starts from ``init``): DD_STEPS
    exact steps, the DD_GATES, n_valid whole and every overflow column 0,
    and exactly d density and d forces launches a step with the counters
    set to 0 just before and read just after; one slab of the 4-slab run's
    next relayout through both kernels against their plain versions
    (hold_physics); ms/step of each and of the single engine, and host
    syncs, device busy ms and kernel launches a step of each (the
    profiler's, over 2 steps); then the 3k C golden through 4 slabs.  Every
    measurement is printed before any gate is asserted."""
    cfg = T.SPHConfig(r=math.sqrt(6.35 / N_POOL))
    fluid, braw = T.build_pool_scene(cfg, DEV)
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, DEV)
    sim0 = eng.prime(fluid, G)
    sim0 = sim0._replace(au=torch.zeros_like(sim0.au), av=torch.zeros_like(sim0.av))
    single = eng.make_multi_step()
    want = eng.unpad(single(sim0, _gravity(DD_STEPS))[0])
    out, failed = {}, []
    out["single_ms_per_step"], runs = _median_ms(
        lambda: single(sim0, _gravity(DD_TIMED_STEPS)), DD_TIMED_STEPS)
    out["single_runs_ms"] = json.dumps(runs)
    prof = device_breakdown(lambda: single(sim0, _gravity(2)), DEV)
    out["single_syncs_per_step"] = prof["syncs"] / 2
    out["single_device_busy_ms_per_step"] = prof["busy_s"] * 1e3 / 2
    out["single_launches_per_step"] = sum(r[2] for r in prof["rows"]) / 2
    launches = {}
    for d in DD_SLABS:
        dd = WindowDomain(cfg, b, bg, fluid.n, LocalComm(d), DEV)
        state0 = dd.init(fluid)
        multi = dd.make_multi_step()
        _reset_counts()
        state, st = multi(state0, _gravity(DD_STEPS))
        counts = _counts()
        launches[d] = counts
        err = _dd_errors(dd.gather(state), want)
        print(f"  dd {d} slabs: k_cols {dd.k_cols}, slab_cap {dd.slab_cap}, halo_cap "
              f"{dd.halo_cap}, mig_cap {dd.mig_cap}, nb_cap {dd.nb_cap}, n_layout "
              f"{dd.spec.n_layout}; after {DD_STEPS} steps against the single engine "
              f"{json.dumps(err)}; launches {json.dumps(counts)}", flush=True)
        checks = {
            "x, y": max(err["x"], err["y"]) <= DD_GATES["xy"],
            "u": err["u"] <= DD_GATES["u"],
            "rho": err["rho_excess"] <= DD_GATES["rho_atol"],
            "n_valid": bool((st["n_valid"] == fluid.n).all()),
            "overflow": int(st["overflow"].max()) == 0,
            "overflow_by": int(st["overflow_by"].max()) == 0,
            "launches": counts["density_window"] == counts["forces_window"] == d * DD_STEPS
            and all(counts[k] == 0 for k in KERNELS if k not in SIM_KERNELS[:2]),
            "finite": bool(torch.isfinite(state.fluid.x).all()),
        }
        failed += [f"{d} slabs: {k}" for k, ok in checks.items() if not ok]
        out[f"dd{d}_err"] = json.dumps(err)
        out[f"dd{d}_ms_per_step"], runs = _median_ms(
            lambda: multi(state0, _gravity(DD_TIMED_STEPS)), DD_TIMED_STEPS)
        out[f"dd{d}_runs_ms"] = json.dumps(runs)
        prof = device_breakdown(lambda: multi(state0, _gravity(2)), DEV)
        out[f"dd{d}_syncs_per_step"] = prof["syncs"] / 2
        out[f"dd{d}_device_busy_ms_per_step"] = prof["busy_s"] * 1e3 / 2
        out[f"dd{d}_launches_per_step"] = sum(r[2] for r in prof["rows"]) / 2
        if d == 4:
            eng1, pk, ctx = dd.layouts(state)[1]
            h = hold_physics(eng1, pk, ctx)
            out["slab1_kernels_vs_plain"] = json.dumps(
                {k: h[k] for k in ("rel_rho", "d_p", "d_acc", "d_uv")})
        del dd, state, state0
    for name in SIM_KERNELS[:2]:
        results[name]["dd_launches"] = {d: c[name] for d, c in launches.items()}

    golden = np.load(HERE / "tests" / "fixtures" / "golden_drop_3k.npz")
    cfg3 = T.SPHConfig(r=0.0226)
    fluid3, braw3 = T.build_drop_scene(cfg3, DEV)
    b3, bg3 = T.prepare_boundary(braw3, cfg3)
    dd = WindowDomain(cfg3, b3, bg3, fluid3.n, LocalComm(4), DEV)
    state, st = dd.make_multi_step()(dd.init(fluid3), _gravity(DD_GOLDEN_STEPS))
    gs = golden["states"][DD_GOLDEN_STEPS // 100]
    assert int(golden["steps"][DD_GOLDEN_STEPS // 100]) == DD_GOLDEN_STEPS
    ours = dd.gather(state)
    gerr = {f: float(np.abs(getattr(ours, f).cpu().numpy() - gs[:, i]).max())
            for i, f in enumerate("xyuv")}
    gerr["rho_rel"] = float((np.abs(ours.rho.cpu().numpy() - gs[:, 5]) / gs[:, 5]).max())
    out["golden_3k_4_slabs_step200"] = json.dumps(gerr)
    print(f"  dd 4 slabs, 3k C golden at step {DD_GOLDEN_STEPS}: {json.dumps(gerr)}",
          flush=True)
    if not (max(gerr["x"], gerr["y"]) <= DD_GOLDEN_GATES["xy"]
            and max(gerr["u"], gerr["v"]) <= DD_GOLDEN_GATES["uv"]
            and gerr["rho_rel"] <= DD_GOLDEN_GATES["rho_rel"]):
        failed.append("3k golden")
    if int(st["overflow"].max()) or not bool((st["n_valid"] == fluid3.n).all()):
        failed.append("3k golden: overflow or n_valid")
    assert not failed, f"dd: {failed}"
    return out


def _counted(fn, ticks: int, label: str) -> dict:
    """The profiler's host syncs, kernel launches and device-busy ms of one
    call of ``fn``, divided by ``ticks``."""
    b = device_breakdown(fn, DEV)
    return {f"{label}_syncs": b["syncs"] / ticks,
            f"{label}_launches": sum(r[2] for r in b["rows"]) / ticks,
            f"{label}_device_busy_ms": b["busy_s"] * 1e3 / ticks}


def run_dd_sticky(results: dict) -> dict:
    """Sticky groups on the card: the 100k pool as 1 and 4 slabs at
    resort_every=4 for DD_STICKY_TICKS ticks from ``init``, with the counters
    set to 0 just before and read just after: exactly d density and d forces
    launches a tick; against the same domain at r1 and against the single
    engine (primed, accelerations zeroed) at r4 (DD_STICKY_GATES); n_valid
    whole on every sampled tick, every overflow column 0, stale 0.  Then ms
    a tick at r4 and r64 (CUDA events, median of 5), the host syncs,
    launches and device-busy ms of a carried tick (the profiler over a
    10-tick group less a 2-tick one, over 8), and one slab of the 4-slab
    domain's carried tick through both kernels against their plain
    versions (hold_physics on the packed state the kernels were given).
    Every measurement is printed before any gate is asserted."""
    cfg = T.SPHConfig(r=math.sqrt(6.35 / N_POOL))
    fluid, braw = T.build_pool_scene(cfg, DEV)
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, DEV)
    sim0 = eng.prime(fluid, G)
    sim0 = sim0._replace(au=torch.zeros_like(sim0.au), av=torch.zeros_like(sim0.av))
    n_t, k = DD_STICKY_TICKS, DD_STICKY_R
    single = eng.make_multi_step(resort_every=k)
    want = eng.unpad(single(sim0, _gravity(n_t))[0])
    out, failed, launches = {}, [], {}
    out["single_r4_ms_per_tick"] = _median_ms(lambda: single(sim0, _gravity(n_t)), n_t)[0]
    single64 = eng.make_multi_step(resort_every=64)
    out["single_r64_ms_per_tick"] = _median_ms(lambda: single64(sim0, _gravity(64)), 64)[0]
    for d in DD_STICKY_SLABS:
        dd = WindowDomain(cfg, b, bg, fluid.n, LocalComm(d), DEV)
        state0 = dd.init(fluid)
        exact = dd.gather(dd.make_multi_step()(state0, _gravity(n_t))[0])
        multi = dd.make_multi_step(resort_every=k)
        _reset_counts()
        state, st = multi(state0, _gravity(n_t))
        counts = _counts()
        launches[d] = counts
        got = dd.gather(state)
        err, err_single = _dd_errors(got, exact), _dd_errors(got, want)
        sampled = torch.tensor([i % k in (0, k - 1) for i in range(n_t)], device=DEV)
        print(f"  dd sticky {d} slabs, r{k}, {n_t} ticks: against r1 {json.dumps(err)}; "
              f"against the single engine at r{k} {json.dumps(err_single)}; "
              f"launches {json.dumps(counts)}", flush=True)
        checks = {
            "x, y against r1": max(err["x"], err["y"]) <= DD_STICKY_GATES["xy"],
            "u against r1": err["u"] <= DD_STICKY_GATES["u"],
            "rho against r1": err["rho_excess"] <= DD_GATES["rho_atol"],
            "x, y against the single engine":
                max(err_single["x"], err_single["y"]) <= DD_STICKY_GATES["single_xy"],
            "u against the single engine": err_single["u"] <= DD_STICKY_GATES["single_u"],
            "n_valid": bool((st["n_valid"][sampled] == fluid.n).all()),
            "overflow": int(st["overflow"].max()) == 0,
            "overflow_by": int(st["overflow_by"].max()) == 0,
            "stale": int(st["stale"].sum()) == 0,
            "launches": counts["density_window"] == counts["forces_window"] == d * n_t
            and all(counts[name] == 0 for name in KERNELS if name not in SIM_KERNELS[:2]),
            "finite": bool(torch.isfinite(state.fluid.x).all()),
        }
        failed += [f"{d} slabs: {name}" for name, ok in checks.items() if not ok]
        out[f"dd{d}_r1_err"], out[f"dd{d}_single_r4_err"] = json.dumps(err), json.dumps(err_single)
        out[f"dd{d}_r4_ms_per_tick"] = _median_ms(lambda: multi(state0, _gravity(n_t)), n_t)[0]
        multi64 = dd.make_multi_step(resort_every=64)
        out[f"dd{d}_r64_ms_per_tick"] = _median_ms(lambda: multi64(state0, _gravity(64)), 64)[0]
        prof = {}
        for kk in DD_CARRIED:
            group = dd.make_multi_step(resort_every=kk)
            group(state0, _gravity(kk))
            prof[kk] = _counted(lambda: group(state0, _gravity(kk)), 1, "g")
        extra = DD_CARRIED[1] - DD_CARRIED[0]
        for key in prof[DD_CARRIED[0]]:
            out[f"dd{d}_carried_{key[2:]}_per_tick"] = \
                (prof[DD_CARRIED[1]][key] - prof[DD_CARRIED[0]][key]) / extra
        if d == 4:
            # slab 1's carried tick: the second tick's second call of _pair_acc
            calls, pair_acc = [], engine_v3.WindowEngine._pair_acc

            def spy(self, pk, ctx, *args):
                calls.append((self, pk, ctx))
                return pair_acc(self, pk, ctx, *args)

            with mock.patch.object(engine_v3.WindowEngine, "_pair_acc", spy):
                dd.make_multi_step(resort_every=2)(state, _gravity(2))
            h = hold_physics(*calls[d + 1])
            out["slab1_carried_kernels_vs_plain"] = json.dumps(
                {name: h[name] for name in ("rel_rho", "d_p", "d_acc", "d_uv")})
            out["last_state"] = (dd, state, eng)
        del dd, state0
    for name in SIM_KERNELS[:2]:
        results[name]["dd_sticky_launches"] = {d: c[name] for d, c in launches.items()}
    print("  " + json.dumps({key: v for key, v in out.items() if key != "last_state"}),
          flush=True)
    assert not failed, f"dd_sticky: {failed}"
    return out


def run_dd_render(results: dict, dd, state, eng) -> dict:
    """The per-slab renderer on the card: the 100k pool's 4-slab state after
    the sticky run (``eng``: the single engine of the same pool), at 64x128
    and 256x128.  DD_RENDER_FRAMES frames with the
    counters set to 0 just before and read just after: exactly 4 field
    launches a frame and no other kernel; the framebuffer against
    ``WindowRenderer.render`` on the gathered state (at least 99.9% of the
    pixels equal); slab 1's field kernel against its plain version on the
    inputs it was given (max |d| over max |field| at most 1e-5); ms a frame
    (CUDA events) and the launches and syncs of a frame (the profiler)."""
    d, n = dd.n_slabs, DD_RENDER_FRAMES
    packed = eng._initial_packed(dd.gather(state))
    zero = torch.zeros_like(packed[:, 0])
    sim = T.PackedSim(packed=packed, ids=packed[:, 7].int(), au=zero, av=zero)
    out, failed = {}, []
    for rows, cols in SHAPES:
        tag = f"{rows}x{cols}"
        render = dd.make_render(rows, cols)
        fb, ov = render(state)
        _reset_counts()
        for _ in range(n):
            render(state)
        _sync()
        counts = _counts()
        results["field_window"][f"dd_render_{tag}_launches"] = counts["field_window"]
        ref, ov_ref = mw.WindowRenderer(eng, rows, cols).render(sim)
        same = T.unpack_framebuffer(fb.cpu().numpy(), rows, cols) == \
            T.unpack_framebuffer(ref.cpu().numpy(), rows, cols)
        calls = []

        def spy(*args):
            calls.append(args)
            return mw.field_window(*args)

        with mock.patch.object(domain_window, "field_window", spy):
            render(state)
        args = calls[1]
        fk, fp = mw.field_window(*args), mw.field_window_plain(*args)
        _sync()
        rel = float((fk - fp).abs().max()) / float(fp.abs().max())
        out[f"{tag}_equal_pixels"] = int(same.sum())
        out[f"{tag}_pixels"] = same.size
        out[f"{tag}_slab1_field_rel_err"] = rel
        out[f"{tag}_ms_per_frame"] = event_ms(lambda: render(state), n)
        out.update(_counted(lambda: [render(state) for _ in range(n)], n, f"{tag}_frame"))
        out[f"{tag}_overflow"] = int(ov)
        print(f"  dd render {d} slabs {tag}: {int(same.sum())} of {same.size} pixels equal "
              f"to WindowRenderer.render on the gathered state; slab 1 field kernel "
              f"max |d| / max |field| {rel:.3e}; launches in {n} frames "
              f"{json.dumps(counts)}; overflow {int(ov)} (single renderer "
              f"{int(ov_ref)})", flush=True)
        checks = {
            "field launches": counts["field_window"] == d * n
            and all(counts[name] == 0 for name in KERNELS if name != "field_window"),
            "pixels": same.mean() >= 0.999,
            "field kernel": rel <= 1e-5,
            "overflow": int(ov) == 0,
        }
        failed += [f"{tag}: {name}" for name, ok in checks.items() if not ok]
    assert not failed, f"dd_render: {failed}"
    return out


def run_runner_dd() -> dict:
    """``cli run --backend window-dd --slabs 4`` on the card, as a user
    starts it: the dam at the CLI defaults (resort_every 8 and its ladder,
    cap 384, recovery on) with a file display, RUNNER_DD_DISPATCHES
    dispatches, the counters set to 0 just before and read just after:
    frames written = dispatches run less one a revert, field launches = 4 x
    the dispatches run (replays included), density and forces launched,
    overflow and stale 0 at the end.  Also returns the frame file's bytes
    and the recovery lines, which runner_dd_mp holds its processes to."""
    k = RUNNER_DD_K
    err, spans = io.StringIO(), {}
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "frames.bin"
        _reset_counts()
        with contextlib.redirect_stderr(err), _relayout_spans(spans):
            res = cli.main(_runner_dd_argv(path))
        counts = dict(_counts(), **spans)
        raw = path.read_bytes()
    sys.stderr.write(err.getvalue())
    frames = np.frombuffer(raw, np.uint8).reshape(-1, 1024)
    info = dict(k=k, dispatches=RUNNER_DD_DISPATCHES, run=res.dispatches,
                recoveries=res.recoveries, frames=frames.shape[0], launches=counts,
                overflow=res.reporter.total_overflow, stale=res.reporter.total_stale,
                wall_s=res.wall_s, ps_per_s=res.particle_steps_per_s,
                worst_speed=res.reporter.worst_speed)
    print("  " + json.dumps(info), flush=True)
    assert res.steps == RUNNER_DD_DISPATCHES * k, (res.steps, k)
    assert frames.shape[0] == res.dispatches - res.recoveries, info
    assert counts["field_window"] == RUNNER_DD_SLABS * res.dispatches, info
    assert counts["density_window"] > 0 and counts["forces_window"] > 0, info
    _check_relayouts(counts)
    assert res.reporter.total_overflow == 0 and res.reporter.total_stale == 0, info
    assert all(T.unpack_framebuffer(fb).any() for fb in frames), "an unlit frame"
    info["recovery_lines"] = _recovery(err.getvalue())
    info["_frames"] = raw
    return info


def _runner_dd_argv(frames) -> list:
    """runner_dd's ``cli run`` arguments, with the frame file ``frames``."""
    return ["run", "--backend", "window-dd", "--slabs", str(RUNNER_DD_SLABS),
            "--device", DEV.type, "--scene", "dam", "--display", f"file:{frames}",
            "--seconds", repr(RUNNER_DD_DISPATCHES * RUNNER_DD_K * T.SPHConfig().dt)]


def _recovery(text: str) -> list:
    """The runner's recovery and ladder lines of a run's standard error."""
    return [ln for ln in text.splitlines() if ln.startswith(RECOVERY)]


def _spawn_pair(argv_of) -> list:
    """``python argv_of(i)`` for i < DD_MP_PROCS, all started together from
    the checkout's root; waits for all, kills all at MP_TIMEOUT and raises;
    raises unless every one exits 0.  Returns each one's (stdout, stderr),
    whose last lines it prints."""
    procs = [subprocess.Popen([sys.executable, *argv_of(i)], cwd=str(HERE),
                              env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                                  [str(HERE), os.environ.get("PYTHONPATH", "")])),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(DD_MP_PROCS)]
    try:
        outs = [p.communicate(timeout=MP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        tail = "\n".join((out + err).strip().splitlines()[-6:])
        print(f"  process {i} exited {p.returncode}:\n    " + tail.replace("\n", "\n    "),
              flush=True)
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n{err[-4000:]}"
    return outs


def dd_worker(argv: list) -> int:
    """One process of the dd_multiprocess phase (``chip_smoke.py --dd-worker``
    followed by the worker's flags): the worker's run
    (multihost_worker.main, which prints the ``multihost OK`` line) with
    the counters set to 0 just before and read just after; then, every
    process making the same collective calls in the same order: ms a tick
    of the sticky group from the exact step's state (CUDA events, median of
    DD_RUNS), the bytes staged a tick, a carried tick's host syncs,
    launches, device-busy ms and staged bytes (a 10-tick group less a
    2-tick one, over 8), this process's first slab through the density and
    forces kernels on its carried tick (hold_physics) and through the field
    kernel on its frame, against their plain versions; and the peak device
    memory.  Prints one ``DDMP {...}`` line."""
    import torch.distributed as dist

    _reset_counts()
    res = multihost_worker.main(argv)
    _sync()
    counts = _counts()
    dd, comm = res.dd, res.comm
    first, n_local = comm.slabs.start, len(comm.slabs)
    out = dict(process=comm.rank, slabs=[first, comm.slabs.stop - 1], launches=counts,
               staged_bytes_run=comm.staged_bytes)
    multi = dd.make_multi_step(resort_every=DD_MP_TICKS)
    out["r64_ms_per_tick"], out["r64_runs_ms"] = _median_ms(
        lambda: multi(res.exact, _gravity(DD_MP_TICKS)), DD_MP_TICKS)
    before = comm.staged_bytes
    multi(res.exact, _gravity(DD_MP_TICKS))
    out["staged_bytes_per_tick"] = (comm.staged_bytes - before) / DD_MP_TICKS
    prof, staged = {}, {}
    for kk in DD_CARRIED:
        group = dd.make_multi_step(resort_every=kk)
        group(res.exact, _gravity(kk))
        before = comm.staged_bytes
        prof[kk] = _counted(lambda: group(res.exact, _gravity(kk)), 1, "g")
        staged[kk] = comm.staged_bytes - before
    extra = DD_CARRIED[1] - DD_CARRIED[0]
    for key in prof[DD_CARRIED[0]]:
        out[f"carried_{key[2:]}_per_tick"] = \
            (prof[DD_CARRIED[1]][key] - prof[DD_CARRIED[0]][key]) / extra
    out["carried_staged_bytes_per_tick"] = \
        (staged[DD_CARRIED[1]] - staged[DD_CARRIED[0]]) / extra

    # the first local slab's carried tick: the second tick's first call
    calls, pair_acc = [], engine_v3.WindowEngine._pair_acc

    def spy(self, pk, ctx, *args):
        calls.append((self, pk, ctx))
        return pair_acc(self, pk, ctx, *args)

    with mock.patch.object(engine_v3.WindowEngine, "_pair_acc", spy):
        dd.make_multi_step(resort_every=2)(res.state, _gravity(2))
    h = hold_physics(*calls[n_local])
    out[f"slab{first}_carried_kernels_vs_plain"] = {
        name: h[name] for name in ("rel_rho", "d_rho", "d_p", "d_acc", "d_uv")}
    fcalls = []

    def fspy(*args):
        fcalls.append(args)
        return mw.field_window(*args)

    with mock.patch.object(domain_window, "field_window", fspy):
        dd.make_render(*multihost_worker.FRAME)(res.state)
    fk, fp = mw.field_window(*fcalls[0]), mw.field_window_plain(*fcalls[0])
    _sync()
    out[f"slab{first}_field_max_abs_err"] = float((fk - fp).abs().max())
    out[f"slab{first}_field_rel_err"] = rel = \
        out[f"slab{first}_field_max_abs_err"] / float(fp.abs().max())
    out["peak_bytes_in_use"] = device_memory()[f"cuda:{DEV.index or 0}"]["peak_bytes_in_use"]
    print("DDMP " + json.dumps(out), flush=True)
    assert rel <= 1e-5, f"slab {first}: field kernel rel err {rel}"
    dist.destroy_process_group()
    return 0


def run_dd_multiprocess(results: dict) -> dict:
    """The 100k pool as DD_MP_SLABS slabs over DD_MP_PROCS processes on this
    card (dd_worker), against the same sequence over LocalComm(DD_MP_SLABS)
    in this process: the export (every FluidState field, au, av) and the
    frame bitwise; in each process exactly (slabs it holds) density and
    forces launches a tick and field launches a frame and no other kernel;
    its first slab's kernels within the dd_sticky and dd_render gates
    (hold_physics raises; the field within 1e-5 of max |field|).  ms a tick
    at r64 of each process beside the in-process run's."""
    dd, fluid = multihost_worker.build(LocalComm(DD_MP_SLABS), DEV, N_POOL)
    _reset_counts()
    ref = multihost_worker.run(dd, fluid, DD_MP_TICKS, DD_MP_TICKS)
    _sync()
    ref_counts = _counts()
    multi = dd.make_multi_step(resort_every=DD_MP_TICKS)
    out = {"in_process_launches": json.dumps(ref_counts)}
    out["in_process_r64_ms_per_tick"], runs = _median_ms(
        lambda: multi(ref.exact, _gravity(DD_MP_TICKS)), DD_MP_TICKS)
    out["in_process_r64_runs_ms"] = json.dumps(runs)
    per = DD_MP_SLABS // DD_MP_PROCS
    with tempfile.TemporaryDirectory() as tmp:
        npz = pathlib.Path(tmp) / "export.npz"
        url = (pathlib.Path(tmp) / "store").as_uri()
        outs = _spawn_pair(lambda i: [
            str(HERE / "chip_smoke.py"), "--dd-worker", "--coordinator", url,
            "--num-processes", str(DD_MP_PROCS), "--process-id", str(i),
            "--slabs-per-process", str(per), "--device", DEV.type, "--backend", "gloo",
            "--n", str(N_POOL), "--steps", str(DD_MP_TICKS),
            "--resort-every", str(DD_MP_TICKS), "--out", str(npz)])
        got = dict(np.load(npz))
    workers = []
    for i, (stdout, _) in enumerate(outs):
        assert f"[proc {i}] multihost OK" in stdout, f"process {i}: no multihost OK line"
        workers.append(json.loads(next(ln for ln in stdout.splitlines()
                                        if ln.startswith("DDMP "))[5:]))
    fl, au, av = ref.export
    want = {f: getattr(fl, f).cpu().numpy() for f in type(fl)._fields}
    want.update(au=au.cpu().numpy(), av=av.cpu().numpy(), fb=ref.fb)
    unequal = [key for key, w in want.items() if not np.array_equal(got[key], w)]
    for w in workers:
        print(f"  process {w['process']}: " + json.dumps(w), flush=True)
        out[f"p{w['process']}"] = json.dumps(w)
    out["bitwise_equal"] = not unequal
    print(f"  in process over LocalComm({DD_MP_SLABS}): launches {json.dumps(ref_counts)}, "
          f"{out['in_process_r64_ms_per_tick']:.4f} ms a tick at r{DD_MP_TICKS}; "
          f"fields unequal to the two processes' {unequal}", flush=True)
    for name in SIM_KERNELS:
        results[name]["dd_mp_launches"] = [w["launches"][name] for w in workers]
    ticks = 1 + DD_MP_TICKS
    assert not unequal, f"dd_multiprocess: {unequal} differ from the in-process run"
    assert ref_counts["density_window"] == ref_counts["forces_window"] == DD_MP_SLABS * ticks
    for w in workers:
        c = w["launches"]
        assert c["density_window"] == c["forces_window"] == per * ticks, w
        assert c["field_window"] == per, w
        assert all(c[name] == 0 for name in KERNELS if name not in SIM_KERNELS), w
    return out


def run_runner_dd_mp(ref: dict) -> dict:
    """runner_dd's command as DD_MP_PROCS processes on this card over gloo:
    process 0's frame file byte-equal to runner_dd's (``ref``), the same
    recovery lines; process 1 writes no frame file and prints nothing on
    its standard output (no header, no result)."""
    with tempfile.TemporaryDirectory() as tmp:
        url = (pathlib.Path(tmp) / "store").as_uri()
        frames = [pathlib.Path(tmp) / f"frames{i}.bin" for i in range(DD_MP_PROCS)]
        outs = _spawn_pair(lambda i: [
            "-m", "pi_sph_fluid_tpu_torch.cli", *_runner_dd_argv(frames[i]),
            "--num-processes", str(DD_MP_PROCS), "--coordinator", url,
            "--process-id", str(i), "--dist-backend", "gloo"])
        raw = frames[0].read_bytes()
        others = [f.exists() for f in frames[1:]]
    recovery = _recovery(outs[0][1])
    info = dict(frames=len(raw) // 1024, frames_equal=raw == ref["_frames"],
                recovery_lines=recovery, others_wrote_frames=others,
                others_stdout=[o for o, _ in outs[1:]])
    print("  " + json.dumps(info), flush=True)
    assert raw == ref["_frames"], "process 0's frames differ from runner_dd's"
    assert recovery == ref["recovery_lines"], (recovery, ref["recovery_lines"])
    assert not any(others), "a process above 0 wrote frames"
    assert all(o == "" for o in info["others_stdout"]), info["others_stdout"]
    return info


def run_golden() -> dict:
    """The 3k C golden drop through the kernels at the gates of
    tests/test_parity_3k.py:129 (cap=384, as the JAX engine's gate)."""
    golden = np.load(HERE / "tests" / "fixtures" / "golden_drop_3k.npz")
    cfg = T.SPHConfig(r=0.0226)
    fluid, braw = T.build_drop_scene(cfg, DEV)
    assert fluid.n == int(golden["n_fluid"]) == 3021
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, DEV, cap=384)
    sim = eng.prime(fluid, G)
    multi = eng.make_multi_step()
    gates = {500: (3e-6, 5e-4), 1000: (1e-5, 5e-4), 2000: (5e-5, 2e-3)}
    worst = {}
    for k in range(1, GOLDEN_STEPS // 100 + 1):
        sim, st = multi(sim, _gravity(100))
        assert int(st.neighbor_overflow.max()) == 0, "3k: window overflow"
        step = k * 100
        if step not in gates:
            continue
        pos_tol, vel_tol = gates[step]
        assert int(golden["steps"][k]) == step
        gs = golden["states"][k]
        ours = eng.unpad(sim)
        err = {f: float(np.abs(getattr(ours, f).cpu().numpy() - gs[:, i]).max())
               for i, f in enumerate("xyuv")}
        rho_rel = float((np.abs(ours.rho.cpu().numpy() - gs[:, 5]) / gs[:, 5]).max())
        assert max(err["x"], err["y"]) <= pos_tol, f"3k step {step}: {err}"
        assert max(err["u"], err["v"]) <= vel_tol, f"3k step {step}: {err}"
        assert rho_rel <= 3e-4, f"3k step {step}: rho rel {rho_rel}"
        worst[step] = dict(err, rho_rel=rho_rel)
    return worst


def run() -> dict:
    """Phases 2-16 on the card; returns the per-kernel results."""
    t0 = time.perf_counter()
    # every kernel source at once, one nvcc each; loading both libraries
    # here, before any profiler session, also lets the profiler see them
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        logs = dict(zip(_build.SOURCES, pool.map(lambda n: _build.library(n)[1],
                                                 _build.SOURCES)))
    for name, log in logs.items():
        ptxas = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln]
        _phase("build", t0, source=str(_build.SOURCES[name][0].relative_to(HERE)),
               ptxas=json.dumps(ptxas))
    results = {name: {"name": name, "route": "cuda", "source": k[2],
                      "replaces": k[1]} for name, k in KERNELS.items()}
    results["relayout"] = {"name": "relayout", "route": "cuda", "source": RELAYOUT_SRC,
                           "replaces": "none: the JAX relayout is jnp code"}

    t0 = time.perf_counter()
    eng, fluid = pool_engine(N_POOL, DEV)
    compare_kernels(eng, fluid, results)
    _phase("kernels_vs_plain", t0, n_fluid=fluid.n, n_layout=eng.n_layout, L=eng.spec.L)

    t0 = time.perf_counter()
    host = launch_probe.measure(DEV)
    for name, r in host.items():
        results[name]["host_us"] = r["host_us"]
    _phase("launch_host", t0, **{f"{k}_us": f"{v['host_us']:.2f}" for k, v in host.items()})

    t0 = time.perf_counter()
    _phase("relayout", t0, **run_relayout(results))

    t0 = time.perf_counter()
    pool = run_pool(eng, fluid)
    frames = {"100k": (eng,) + pool.pop("last")}
    _phase("pool_100k", t0, n_fluid=fluid.n, **pool)

    t0 = time.perf_counter()
    _phase("dd", t0, **run_dd(results))

    t0 = time.perf_counter()
    sticky = run_dd_sticky(results)
    last = sticky.pop("last_state")
    _phase("dd_sticky", t0, **sticky)

    t0 = time.perf_counter()
    _phase("dd_render", t0, **run_dd_render(results, *last))
    del last

    t0 = time.perf_counter()
    _phase("dd_multiprocess", t0, **run_dd_multiprocess(results))

    t0 = time.perf_counter()
    worst = run_golden()
    _phase("golden_3k", t0, steps=GOLDEN_STEPS, worst=json.dumps(worst))

    t0 = time.perf_counter()
    big, big_fluid = pool_engine(N_BIG, DEV)
    sim = big.prime(big_fluid, G)
    multi = big.make_multi_step(resort_every=64, return_frame=True)
    multi(sim, _gravity(64))    # warm-up: the allocator's first 1M-row blocks
    _sync()
    t1 = time.perf_counter()
    sim, st, frame = multi(sim, _gravity(64))
    _sync()
    wall = time.perf_counter() - t1
    _check_state(sim, st, "1M pool")
    frames["1M"] = (big, sim, frame)
    _phase("pool_1m", t0, n_fluid=big_fluid.n, ms_per_step=wall / 64 * 1e3,
           ps_per_s=big_fluid.n * 64 / wall)

    t0 = time.perf_counter()
    _phase("render", t0, **run_render(frames))
    del frames, big, sim

    t0 = time.perf_counter()
    _phase("golden_render", t0, agreement=json.dumps(run_golden_render()))

    t0 = time.perf_counter()
    info = run_runner()
    capture = info.pop("_capture")
    for name in SIM_KERNELS:
        results[name]["launches"] = info["launches"][name]
        results[name]["library_ms"] = None
    results["relayout"]["launches"] = info["launches"]["relayout"]
    _phase("runner", t0, **info)

    t0 = time.perf_counter()
    _phase("runner_recovery", t0, **run_recovery())

    t0 = time.perf_counter()
    info = run_runner_dd()
    for name in (*SIM_KERNELS, "relayout"):
        results[name]["runner_dd_launches"] = info["launches"][name]
    runner_dd = {key: info.pop(key) for key in ("_frames", "recovery_lines")}
    _phase("runner_dd", t0, recovery_lines=json.dumps(runner_dd["recovery_lines"]), **info)

    t0 = time.perf_counter()
    _phase("runner_dd_mp", t0, **run_runner_dd_mp(runner_dd))

    t0 = time.perf_counter()
    _phase("probes", t0, **run_probes(results))

    t0 = time.perf_counter()
    _phase("bench", t0, **run_bench())

    t0 = time.perf_counter()
    _phase("oracle", t0, **run_oracle())

    t0 = time.perf_counter()
    info = run_tools(capture)
    for name in (*SIM_KERNELS, "relayout"):
        results[name]["tools_launches"] = info["launches"][name]
    _phase("tools", t0, **info)

    t0 = time.perf_counter()
    info = run_divergence()
    for name in SIM_KERNELS[:2]:
        results[name]["divergence_launches"] = info["launches"][name]
    _phase("divergence", t0, **{k: json.dumps(v) for k, v in info.items()})
    for r in results.values():
        r["share"] = r["bound_ms"] / r["device_ms"] if r.get("device_ms") else None
    return results


def run_render(frames: dict) -> dict:
    """render_from_frame ms per frame on each pool's last relayout frame (a
    64-tick sticky group, so the frame is 63 ticks stale as in the runner
    at resort_every=64), both raster shapes.  The pool fills 85% of the
    height (models/scene.py:119-131): the top page stays dark, the bottom
    page is lit."""
    out = {}
    for size, (eng, sim, frame) in frames.items():
        for rows, cols in SHAPES:
            rend = mw.WindowRenderer(eng, rows, cols)
            fb, ov = rend.render_from_frame(sim, frame)
            assert int(ov) == 0, f"{size} {rows}x{cols}: render overflow {int(ov)}"
            img = T.unpack_framebuffer(fb.cpu().numpy(), rows, cols)
            assert not img[:8].any() and img[-8:].any(), f"{size} {rows}x{cols}: frame"
            out[f"{size}_{rows}x{cols}_ms"] = event_ms(
                lambda: rend.render_from_frame(sim, frame), N_FRAMES)
            out[f"{size}_{rows}x{cols}_cap"] = rend.reuse_spec.cap
    return out


def run_golden_render() -> dict:
    """WindowRenderer.render through the field kernel on the C golden
    positions against the C framebuffer dumps: >= 99.5% of the pixels agree
    (test_render_window.py:102, test_parity_3k.py:194)."""
    out = {}
    for golden, r, dumps in (("golden_drop.npz", 0.075, (20, 50, 100, 150, 200)),
                             ("golden_drop_3k.npz", 0.0226, (10, 20))):
        g = np.load(HERE / "tests" / "fixtures" / golden)
        cfg = T.SPHConfig(r=r)
        _, braw = T.build_drop_scene(cfg, DEV)
        b, bg = T.prepare_boundary(braw, cfg)
        eng = T.WindowEngine(cfg, b, bg, g["states"].shape[1], DEV)
        rend = mw.WindowRenderer(eng)
        before = tracer.counters.get("kernel.field.launches", 0)
        for dump in dumps:
            fl = T.FluidState(*(torch.tensor(g["states"][dump][:, j], device=DEV)
                                for j in range(7)))
            packed = eng._initial_packed(fl)
            zero = torch.zeros_like(packed[:, 0])
            fb, ov = rend.render(T.PackedSim(packed=packed, ids=packed[:, 7].int(),
                                             au=zero, av=zero))
            assert int(ov) == 0, f"{golden} dump {dump}: overflow {int(ov)}"
            agree = float((T.unpack_framebuffer(fb.cpu().numpy())
                           == T.unpack_framebuffer(g["framebuffers"][dump])).mean())
            assert agree >= 0.995, f"{golden} dump {dump}: agreement {agree}"
            out[f"{g['states'].shape[1]}@{int(g['steps'][dump])}"] = agree
        assert tracer.counters.get("kernel.field.launches", 0) == before + len(dumps)
    return out


def _cli_run(n_dispatch: int, dt_factor: float, *opts: str):
    """``cli run`` on the 100k pool with a file display for ``n_dispatch``
    dispatches of the default K (one 60 Hz frame of ticks, rounded up to the
    default resort_every=8; the resort ladder on), the launch counters set
    to 0 just before and read just after.  Returns (RunResult, K, the
    counts, the frames written, unpacked); every frame shows the pool, its
    floor row lit."""
    r = math.sqrt(6.35 / N_POOL)
    dt = T.SPHConfig(r=r, dt_factor=dt_factor).dt
    k = -(-int(round(1.0 / (60.0 * dt))) // 8) * 8
    spans = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "frames.bin"
        _reset_counts()
        with _relayout_spans(spans):
            res = cli.main(["run", "--scene", "pool", "--r", repr(r), "--device", "cuda",
                            "--display", f"file:{path}", "--dt-factor", repr(dt_factor),
                            "--seconds", repr(n_dispatch * k * dt), *opts])
        counts = _counts()
        frames = np.fromfile(path, np.uint8).reshape(-1, 1024)
    counts["relayout_spans"] = spans["relayout_spans"]
    assert res.steps == n_dispatch * k, (res.steps, n_dispatch, k)
    assert res.reporter.total_overflow == 0, res.reporter.total_overflow
    assert res.reporter.total_stale == 0, res.reporter.total_stale
    assert all(counts[k] > 0 for k in SIM_KERNELS), counts
    _check_relayouts(counts)
    # one render per dispatch run, replays included; a revert drops the one
    # frame it had pending
    assert counts["field_window"] == res.dispatches, (counts, res.dispatches)
    assert frames.shape[0] == res.dispatches - res.recoveries, \
        f"{frames.shape[0]} frames, {res.dispatches} dispatches, {res.recoveries} reverts"
    imgs = [T.unpack_framebuffer(fb) for fb in frames]
    assert all(img[-1].any() for img in imgs), "a frame with an unlit floor row"
    assert not imgs[0][:8].any(), "first frame: top page lit"
    return res, k, counts, imgs, frames.tobytes()


def run_runner() -> dict:
    """The live path through the CLI, as a user starts it: ``run`` on the
    100k pool for RUN_DISPATCHES dispatches; then ``bench`` on the 1M pool
    with rendering.

    The fresh pool collapses into its 12 cm side gaps in the first 0.3 s
    (jets near 27 m/s on an H100), so this run takes the CLI's advice for
    long fine-resolution runs, --dt-factor 0.4, and starts at the runner's
    cap ceiling, 1024: no recovery, one frame per dispatch.  The defaults
    go through the recoveries (run_recovery)."""
    res, k, counts, imgs, capture = _cli_run(RUN_DISPATCHES, 0.4, "--cap", str(LIVE_CAP))
    assert res.recoveries == 0, f"{res.recoveries} recoveries"
    assert res.dispatches == RUN_DISPATCHES == len(imgs), (res.dispatches, len(imgs))
    # the top page (rows 0-7) is dark until the wall run-up reaches it
    # (after ~0.22 s, 13 frames, on an H100): under a fifth lit in the last
    top_lit = float(imgs[-1][:8].mean())
    assert top_lit < 0.2, f"last frame: {top_lit:.3f} of the top page lit"
    bench = cli.main(["bench", "--n", str(N_BIG), "--steps", "64", "--render"])
    assert bench["neighbor_overflow"] == 0 and bench["stale_drift"] == 0, bench
    return dict(k=k, dispatches=res.dispatches, frames=len(imgs),
                last_top_page_lit=top_lit,
                wall_s=res.wall_s, ps_per_s=res.particle_steps_per_s,
                worst_speed=res.reporter.worst_speed, launches=counts,
                bench_1m_render_ps_per_s=bench["value"], _capture=capture)


def run_recovery() -> dict:
    """``cli run`` on the 100k pool at the CLI defaults (--cap 384,
    --dt-factor 1, --max-cap 1024) through the startup jets: the runner
    must recover (grow the cap or halve resort_every, revert to the last
    clean report, replay), render every replayed dispatch through the field
    kernel, and end with overflow and stale 0."""
    res, k, counts, imgs, _ = _cli_run(RECOVERY_DISPATCHES, 1.0)
    assert res.recoveries > 0, "no recovery at the CLI defaults"
    assert res.dispatches > RECOVERY_DISPATCHES, res.dispatches
    return dict(k=k, dispatches=RECOVERY_DISPATCHES, run=res.dispatches,
                recoveries=res.recoveries, frames=len(imgs), launches=counts,
                wall_s=res.wall_s, worst_speed=res.reporter.worst_speed)


def _lzw_decode(data: bytes, mcs: int) -> list:
    """GIF's variable-width LZW, decoded (the encoder is io/display.GifSink's)."""
    clear = 1 << mcs
    table, width, prev, out, acc, nbits = [], mcs + 1, None, [], 0, 0
    for byte in data:
        acc, nbits = acc | byte << nbits, nbits + 8
        while nbits >= width:
            code, acc, nbits = acc & ((1 << width) - 1), acc >> width, nbits - width
            if code == clear:
                table = [(i,) for i in range(clear)] + [(), ()]
                width, prev = mcs + 1, None
            elif code == clear + 1:
                return out
            else:
                entry = table[code] if code < len(table) else prev + (prev[0],)
                if prev is not None:
                    table.append(prev + (entry[0],))
                out.extend(entry)
                if len(table) == 1 << width and width < 12:
                    width += 1
                prev = entry
    raise AssertionError("no end code in a GIF frame")


def _gif_frames(blob: bytes) -> list:
    """The frames of a GIF89a stream, each a flat list of palette indices."""
    assert blob[:6] == b"GIF89a", blob[:6]
    w, h = int.from_bytes(blob[6:8], "little"), int.from_bytes(blob[8:10], "little")
    pos, frames = 13 + 3 * 2 ** ((blob[10] & 7) + 1), []
    while blob[pos] != 0x3B:
        image = blob[pos] == 0x2C
        assert image or blob[pos] == 0x21, f"GIF block 0x{blob[pos]:02x}"
        mcs = blob[pos + 10] if image else None
        pos += 11 if image else 2       # image descriptor + code size; extension label
        data = bytearray()
        while blob[pos]:                # data sub-blocks
            data += blob[pos + 1:pos + 1 + blob[pos]]
            pos += 1 + blob[pos]
        pos += 1
        if image:
            frames.append(_lzw_decode(bytes(data), mcs))
            assert len(frames[-1]) == w * h, "a GIF frame of the wrong size"
    return frames


def run_tools(capture: bytes) -> dict:
    """The tools of pi_sph_fluid_tpu_torch/tools/ through their main(), at
    full width with cut lengths, the launch counters set to 0 just before
    and read just after: render_probe on the 1M pool at 64x128, dd_probe on
    the 100k pool, dynamic_stale_probe on the 100k dam in both backends,
    cfl_probe on the 100k pool, and frames_to_gif on the runner phase's own
    capture, its GIF decoded frame by frame against the capture.  Any
    overflow, stale count, lost particle or assertion fails the phase."""
    out, spans = {}, {}
    _reset_counts()
    with _relayout_spans(spans):
        _run_tools(capture, out)
    out["launches"] = dict(_counts(), **spans)
    assert all(out["launches"][k] > 0 for k in SIM_KERNELS), out["launches"]
    _check_relayouts(out["launches"])
    return out


def _run_tools(capture: bytes, out: dict) -> None:
    """run_tools' runs, their numbers put in ``out``."""
    dev = ["--device", DEV.type]
    rp = render_probe.main(["--n", str(N_BIG), "--rows", "64", "--cols", "128", *dev])
    assert rp["step_overflow"] == rp["reuse_overflow"] == rp["self_overflow"] == 0, rp
    out.update(render_1m_reuse_ms=rp["render_from_frame_ms"],
               render_1m_self_ms=rp["self_relayout_ms"])
    ddp = dd_probe.main(["--n", str(N_POOL), *dev])
    for k in dd_probe.RESORTS:
        row = ddp[f"r{k}"]
        assert row["overflow"] == 0 and row["n_valid"] == ddp["n"], (k, row)
        out[f"dd_probe_r{k}_ms"] = row["ms_per_step"]
    for backend in ("window", "window-dd"):
        dsp = dynamic_stale_probe.main(["--n", str(N_POOL), "--backend", backend,
                                        *TOOLS_STALE_ARGS, *dev])
        assert dsp["preroll"]["overflow"] == 0, dsp["preroll"]
        for k in TOOLS_STALE_RESORTS:
            row = dsp[f"r{k}"]
            assert row["stale"] == 0 and row["overflow"] == 0, (backend, k, row)
            assert row.get("n_valid", dsp["n"]) == dsp["n"], (backend, k, row)
            out[f"stale_{backend}_r{k}_ms"] = row["ms_per_step"]
    cfl = cfl_probe.main(["--n", str(N_POOL), *TOOLS_CFL_ARGS, *dev])
    for f, res in cfl["factors"].items():
        assert res["rows"] and res["overflow"] == 0 and res["stale"] == 0, (f, res)
        assert res["peak"] < cfl_probe.SPEED_BOUND, (f, res)
        out[f"cfl_{f}_peak_speed"] = res["peak"]
        out[f"cfl_{f}_recoveries"] = res["recoveries"]
    raw = np.frombuffer(capture, np.uint8).reshape(-1, 1024)
    with tempfile.TemporaryDirectory() as tmp:
        src, gif = pathlib.Path(tmp) / "frames.bin", pathlib.Path(tmp) / "run.gif"
        src.write_bytes(capture)
        conv = frames_to_gif.main([str(src), str(gif), "--scale", "1", *dev])
        frames = _gif_frames(gif.read_bytes())
    assert conv["frames_in"] == conv["frames_out"] == len(frames) == len(raw), \
        (conv, len(frames), len(raw))
    for fb, px in zip(raw, frames):
        assert np.array_equal(np.asarray(px, np.uint8).reshape(64, 128),
                              T.unpack_framebuffer(fb)), "a GIF frame differs"
    out["gif_frames"] = len(frames)


def _divergence_run(eng, sim, k: int, ulp: bool, ref: dict | None, cert) -> dict:
    """DIV_TICKS ticks at resort_every k from ``sim`` (every fluid x one ulp
    up first when ``ulp``), in groups of DIV_GROUP ticks.  Every DIV_EVERY
    ticks: the state by id (kept when ``ref`` is None, the r1 run) or its
    max |dx, dy|, max |du, dv| and max relative d rho against ``ref``; the
    summed stale count and the largest overflow so far.  ``cert(fluid)`` runs
    at the end of every group when k is 64."""
    if ulp:
        pk = sim.packed.clone()
        live = pk[:, 4] > 0
        pk[live, 0] = torch.nextafter(pk[live, 0], torch.tensor(math.inf, device=DEV))
        sim = sim._replace(packed=pk)
    multi = eng.make_multi_step(resort_every=k)
    rows, stale, overflow = {}, 0, 0
    for tick in range(DIV_GROUP, DIV_TICKS + 1, DIV_GROUP):
        sim, st = multi(sim, _gravity(DIV_GROUP))
        stale += 0 if st.stale is None else int(st.stale.sum())
        overflow = max(overflow, int(st.neighbor_overflow.max()))
        if k == 64:
            cert(eng.unpad(sim))
        if tick % DIV_EVERY:
            continue
        fl = eng.unpad(sim)
        if ref is None:
            rows[tick] = fl
            continue
        a = ref[tick]
        rows[tick] = dict(
            pos=float(torch.maximum((fl.x - a.x).abs(), (fl.y - a.y).abs()).max()),
            vel=float(torch.maximum((fl.u - a.u).abs(), (fl.v - a.v).abs()).max()),
            rho=float(((fl.rho - a.rho).abs() / a.rho).max()),
            stale=stale, overflow=overflow)
    return dict(rows=rows, stale=stale, overflow=overflow)


def _divergence(scene: str, eng, sim, b, bg) -> dict:
    """The four runs of one scene from ``sim``, the per-DIV_EVERY table
    printed, and the worst stalest-tick density against the jnp oracle."""
    cfg, worst = eng.cfg, [0.0]

    def cert(fl):
        ids = torch.arange(fl.x.shape[0], dtype=torch.int32, device=DEV)
        assert int(simulation._sort_and_neighbors(fl, ids, bg, cfg)[4]) == 0, \
            f"{scene}: the oracle's candidate windows overflow"
        ref = simulation.prime(fl, b, bg, G, cfg)
        rho = ref.fluid.rho[torch.argsort(ref.ids.long())]
        worst[0] = max(worst[0], float(((fl.rho - rho).abs() / rho).max()))

    exact = _divergence_run(eng, sim, 1, False, None, cert)
    runs = {name: _divergence_run(eng, sim, k, ulp, exact["rows"], cert)
            for name, (k, ulp) in DIV_RUNS.items()}
    for tick in range(DIV_EVERY, DIV_TICKS + 1, DIV_EVERY):
        print(f"[divergence] {scene} t={tick} " + " | ".join(
            f"{name}: pos {r['rows'][tick]['pos']:.3g} vel {r['rows'][tick]['vel']:.3g} "
            f"rho {r['rows'][tick]['rho']:.3g} stale {r['rows'][tick]['stale']}"
            for name, r in runs.items()), flush=True)
    last = {name: r["rows"][DIV_TICKS] for name, r in runs.items()}
    out = {"stale": {"r1": exact["stale"], **{n: r["stale"] for n, r in runs.items()}},
           "overflow": {"r1": exact["overflow"],
                        **{n: r["overflow"] for n, r in runs.items()}},
           f"t{DIV_TICKS}": last, "stalest_rho_rel": worst[0]}
    print(f"[divergence] {scene} stalest-tick rho against the oracle: "
          f"{worst[0]:.3g} (gate {CERT_RHO_REL:g}); stale {out['stale']}, "
          f"overflow {out['overflow']}", flush=True)
    assert worst[0] <= CERT_RHO_REL, f"{scene}: stalest-tick rho rel {worst[0]}"
    return out


def run_divergence() -> dict:
    """How far the sticky layout takes the trajectory, on the card: from one
    state, DIV_TICKS ticks at r1, r8, r64 and at r1 from every fluid x moved
    one ulp up (the chaos control), compared by id every DIV_EVERY ticks,
    and at the end of every r64 group (the stalest tick) the state's density
    against models/simulation.prime on the same fluid.  Scenes: the 100k
    pool primed (at the live run's cap; it must show no stale tick and no
    overflow in any run) and the 100k dam after dynamic_stale_probe's
    settle and pre-roll at its defaults."""
    _reset_counts()
    eng, fluid = pool_engine(N_POOL, DEV, cap=LIVE_CAP)
    b, bg = T.prepare_boundary(T.build_pool_scene(eng.cfg, DEV)[1], eng.cfg)
    out = {"pool": _divergence("pool", eng, eng.prime(fluid, G), b, bg)}
    for what in ("stale", "overflow"):
        assert not any(out["pool"][what].values()), out["pool"][what]
    args = dynamic_stale_probe.parse_args(["--n", str(N_POOL), "--device", DEV.type])
    _, _, eng, sim, multi_of = dynamic_stale_probe.build(args, DEV)
    sim, _ = dynamic_stale_probe.surge(sim, multi_of, args.settle,
                                       dynamic_stale_probe.preroll_ticks(args, eng.cfg))
    b, bg = T.prepare_boundary(T.build_dam_break_scene(eng.cfg, DEV)[1], eng.cfg)
    out["dam"] = _divergence("dam", eng, sim, b, bg)
    out["launches"] = _counts()
    return out


def _case(fn, plain, name: str, cost: dict, err: float) -> dict:
    """One probe-kernel case: CUDA-event ms of the kernel (20 launches) and
    of its plain version (3), the profiler's device ms, and the bound."""
    out = dict(max_abs_err=err, ms=event_ms(fn, 20), plain_ms=event_ms(plain, 3),
               device_ms=_device_ms(fn, name), **cost)
    out["share"] = out["bound_ms"] / out["device_ms"]
    return out


def run_probes(results: dict) -> dict:
    """The probe scripts as a user runs them, with the counters at 0 just
    before and read just after; then each kernel against its plain version
    at every shape and form the scripts run.  Copy: bitwise.  Span: within
    rtol 1e-5 of max |out| (the sums run in another order, and nvcc
    contracts a*b + c into FMAs)."""
    _reset_counts()
    copy_main, span_main = up.main([]), sp.main([])
    counts = _counts()
    assert counts["window_copy"] > 0 and counts["span_density"] > 0, counts
    assert all(counts[k] == 0 for k in SIM_KERNELS), counts
    cases = {}
    for L, n_tiles in up.SHAPES:
        src_np, al, un = up.make_starts(L, n_tiles)
        src = torch.from_numpy(src_np).to(DEV)
        for form, st in (("aligned", al), ("unaligned", un)):
            starts = torch.from_numpy(st).to(DEV)
            aligned = form == "aligned"
            got = up.window_copy(starts, src, aligned=aligned)
            assert torch.equal(got, up.window_copy_plain(starts, src)), (L, form)
            case = _case(lambda: up.window_copy(starts, src, aligned=aligned),
                         lambda: up.window_copy_plain(starts, src), "window_copy",
                         up.copy_cost(starts, src), 0.0)
            idx = (starts.long()[..., None]
                   + torch.arange(up.CAP, device=DEV)).contiguous()
            case["library_ms"] = event_ms(lambda: src[:, idx], 20)
            case["library_device_ms"] = call_device_ms(lambda: src[:, idx], DEV)
            cases[f"copy_L{L}_{form}"] = case
        del src, got
    for n_layout, L in sp.SHAPES:
        for v, (spans, cap) in sp.VARIANTS.items():
            q, src, w_s = sp.make_inputs(n_layout, L, spans, cap, DEV)
            got = sp.span_density(q, src, w_s, spans, cap)
            want = sp.span_density_plain(q, src, w_s, spans, cap)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            assert scale > 0 and err <= 1e-5 * scale, (n_layout, v, err, scale)
            case = _case(lambda: sp.span_density(q, src, w_s, spans, cap),
                         lambda: sp.span_density_plain(q, src, w_s, spans, cap),
                         "span_density", sp.span_cost(q, src, w_s, spans, cap), err)
            case["err_over_max_out"] = err / scale
            case["library_ms"] = case["library_device_ms"] = None
            cases[f"span_n{n_layout}_{v}"] = case
        del q, src, w_s, got, want
    # the kernels line carries each probe at its JAX probe's own shape (the
    # copy in the port's exact-start form, the span in the shipped 1x512
    # form), and every case beside it
    for name, prefix, key in (
            ("window_copy", "copy_", f"copy_L{up.SHAPES[0][0]}_unaligned"),
            ("span_density", "span_", f"span_n{sp.SHAPES[0][0]}_A")):
        results[name].update(launches=counts[name], case=key, **cases[key])
        results[name]["cases"] = {k: v for k, v in cases.items() if k.startswith(prefix)}
    for key, c in cases.items():
        print(f"  {key}: kernel {c['ms']:.4f} ms, device {c['device_ms']:.4f} ms, "
              f"plain {c['plain_ms']:.4f} ms, library {c['library_ms']} ms, "
              f"library device {c['library_device_ms']} ms; "
              f"{c['bytes']} B, {c['flops']} FLOP, bound {c['bound_ms']:.6f} ms by "
              f"{c['bound_by']}, share {c['share']:.3f}; max |err| {c['max_abs_err']:.3e}"
              + (f" ({c['err_over_max_out']:.3e} of max |out|)"
                 if "err_over_max_out" in c else ""), flush=True)
    ratios = {}
    for L, n_tiles in up.SHAPES:
        a, u = cases[f"copy_L{L}_aligned"], cases[f"copy_L{L}_unaligned"]
        ratios[f"copy_L{L}_unaligned_over_aligned_device"] = u["device_ms"] / a["device_ms"]
    for n_layout, _ in sp.SHAPES:
        a = cases[f"span_n{n_layout}_A"]["device_ms"]
        for v in ("B", "C"):
            ratios[f"span_n{n_layout}_{v}_over_A_device"] = \
                cases[f"span_n{n_layout}_{v}"]["device_ms"] / a
    return dict(launches=counts, copy_main=json.dumps(copy_main),
                span_main=json.dumps(span_main), ratios=json.dumps(ratios))


def run_bench() -> dict:
    """``python -m pi_sph_fluid_tpu_torch.bench`` at its defaults in a
    subprocess, its JSON line gated and printed."""
    proc = subprocess.run([sys.executable, "-m", "pi_sph_fluid_tpu_torch.bench"],
                          cwd=str(HERE), capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    for k in ("neighbor_overflow", "stale_drift", "render_overflow"):
        assert line[k] == 0, (k, line)
    assert line["m1"]["neighbor_overflow"] == 0 and line["m1"]["stale_drift"] == 0, line
    assert line["device"] == torch.cuda.get_device_name(0), line
    assert "not_ported" not in line, line
    for row in (line["dd"], *line["dd_strong"].values()):
        assert row["slabs_measured"] == 1 and row["overflow"] == 0, row
        assert row["stale_drift"] == 0 and "not measured" in row["scaling_across_cards"], row
    print(json.dumps(line), flush=True)
    return dict(value=line["value"], exact_ps_per_s=line["exact_ps_per_s"],
                r8_ps_per_s=line["r8_ps_per_s"], m1_ms_per_step=line["m1"]["ms_per_step"],
                dd_ps_per_s_per_slab=line["dd"]["ps_per_s_per_slab"])


def run_oracle() -> dict:
    """The jnp-oracle backend on the card: the 269 drop through step 500
    against the C golden at test_parity.py's gates, launching no window
    kernel; then ``cli run --backend reference`` with a file display."""
    golden = np.load(HERE / "tests" / "fixtures" / "golden_drop.npz")
    cfg = T.SPHConfig()
    fluid, braw = T.build_drop_scene(cfg, DEV)
    b, bg = T.prepare_boundary(braw, cfg)
    _reset_counts()
    _sync()
    t0 = time.perf_counter()
    sim = simulation.prime(fluid, b, bg, G, cfg)
    multi = simulation.make_multi_step(cfg, b, bg)
    worst, step = {}, 0
    for stop, (pos_tol, vel_tol) in ORACLE_GATES.items():
        sim, st = multi(sim, _gravity(stop - step))
        step = stop
        assert int(st.neighbor_overflow.max()) == 0, f"oracle step {stop}: overflow"
        gs = golden["states"][stop // 10]
        inv = torch.argsort(sim.ids.long())
        err = {f: float(np.abs(getattr(sim.fluid, f)[inv].cpu().numpy() - gs[:, i]).max())
               for i, f in enumerate("xyuv")}
        assert max(err["x"], err["y"]) <= pos_tol, f"oracle step {stop}: {err}"
        assert max(err["u"], err["v"]) <= vel_tol, f"oracle step {stop}: {err}"
        worst[stop] = err
    _sync()
    ticks_per_s = step / (time.perf_counter() - t0)
    assert all(c == 0 for c in _counts().values()), _counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "frames.bin"
        res = cli.main(["run", "--backend", "reference", "--device", "cuda",
                        "--scene", "drop", "--seconds", "0.1", "--display",
                        f"file:{path}"])
        frames = np.fromfile(path, np.uint8).reshape(-1, 1024)
    assert res.reporter.total_overflow == 0 and res.recoveries == 0
    assert 1 <= frames.shape[0] <= res.dispatches, (frames.shape, res.dispatches)
    assert all(T.unpack_framebuffer(fb).any() for fb in frames), "an unlit frame"
    return dict(worst=json.dumps(worst), ticks_per_s=ticks_per_s,
                cli_dispatches=res.dispatches, cli_frames=frames.shape[0],
                cli_ps_per_s=res.particle_steps_per_s)


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the GPU")
    if sys.argv[1:2] == ["--dd-worker"]:
        return dd_worker(sys.argv[2:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    _phase("environment", t0, torch=torch.__version__, cuda=torch.version.cuda,
           nvcc=json.dumps(nvcc), gpu=json.dumps(smi))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = run()
    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
