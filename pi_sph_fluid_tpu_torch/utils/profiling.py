"""Throughput and device-time breakdown of the stepper (counterpart of
`pi_sph_fluid_tpu/utils/profiling.py`: the reference's ticks/s meter,
`pi_sph_fluid.c:680-687`, plus device tracing).

* ``pool_engine(n_target, device)``: bench.py's pool scene and a
  WindowEngine on it;
* ``throughput(multi_step, sim, g_trace, n_particles)``: median
  particle-steps/s of ``multi_step(sim, g_trace)`` over repeats, each from
  the same ``sim``, with the device synchronised around each one;
* ``device_breakdown(fn)``: one call of ``fn`` under ``torch.profiler``:
  wall time, device time per CUDA kernel, and host synchronisations;
* ``resolve_device(name, prog)``: a command's ``--device`` as (device,
  its name), raising without a card unless the CPU was asked for;
* ``event_ms(fn, reps)``: mean ms of ``fn()`` by CUDA events;
  ``wall_ms(fn, reps, device)``: mean ms of ``fn()`` by the host clock
  between two synchronisations (any device), and ``timed(fn, device)``
  one call's result and seconds so;
  ``host_us(fn, reps)``: mean host microseconds of ``fn()`` with the device
  left to run behind (what a kernel wrapper costs the host per launch);
  ``kernel_device_ms(fn, name, device)``: the profiler's device ms per
  launch of one CUDA kernel, and ``call_device_ms(fn, device)`` the same
  for a whole library call;
* ``covered(starts, lens, L)``: the distinct rows of [0, L) that a set of
  windows touches, ``pairs_in_reach(pk, b_geo, spans, cfg, spec)``: the
  (query, lane) pairs of a relayout within 2H, and ``bound(nbytes,
  flops)``: the least time the card could take for them (the H100 SXM
  peaks), for a kernel's roofline;
* ``trace(path)``: a ``torch.profiler`` session around a block, written to
  ``path`` as a Chrome trace (chrome://tracing, Perfetto);
  ``device_memory()``: each card's bytes in use, peak and limit.

Run as a script on the GPU, it measures the pool at 100k and 1M particles
(bench.py's operating points) at resort_every=1 and 64: the spread of
ms/tick over 5 repeats, then where the device time of a tick goes (with
the share of the two window kernels, of the per-relayout span build that
feeds them, and of any row gather left), and where the time of a rendered
frame goes (``render_from_frame`` at 64x128 and 256x128 on the r64 run's
last frame, 20 frames: the field kernel, the unsort gather of its output,
and the rest, which is the overflow count, the scale, the threshold and the
page pack):

    python -m pi_sph_fluid_tpu_torch.utils.profiling
"""

from __future__ import annotations

import contextlib
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
from ..ops.grid import cell_ids, csr_starts
from ..ops.window import window_kernels as wk
from ..ops.window.triple import block_spans, build_frame, start_grid
from ..render.metaballs_window import WindowRenderer

__all__ = ["pool_engine", "resolve_device", "throughput", "device_breakdown",
           "event_ms", "wall_ms", "timed",
           "host_us", "kernel_device_ms", "call_device_ms", "covered",
           "pairs_in_reach", "bound",
           "trace", "device_memory", "PEAK_BYTES", "PEAK_FLOPS"]

G = (0.0, -9.81)
N_FRAMES = 20           # rendered frames per breakdown
# the card's peaks (NVIDIA H100 SXM data sheet, at a 700 W limit): device
# memory bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12


def pool_engine(n_target: int, device, **engine_kw):
    """(WindowEngine, FluidState) of bench.py's pool at about ``n_target``
    particles: r = sqrt(6.35 / n_target) (`bench.py:57-66`)."""
    cfg = SPHConfig(r=math.sqrt(6.35 / n_target))
    fluid, braw = build_pool_scene(cfg, device)
    b, bg = prepare_boundary(braw, cfg)
    return WindowEngine(cfg, b, bg, fluid.n, device, **engine_kw), fluid


def resolve_device(name: str, prog: str) -> tuple[torch.device, str]:
    """(torch device, its name) of a command's ``--device``: ``cuda[:N]``
    raises SystemExit without a card (there is no CPU fallback) and ``cpu``
    runs the kernels' plain versions."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"{prog}: no CUDA device (torch.cuda.is_available() is "
                             "False); pass --device cpu to run the plain versions")
        return device, torch.cuda.get_device_name(device)
    if device.type != "cpu":
        raise SystemExit(f"{prog}: unsupported device {name!r}")
    return device, "cpu"


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
    the count of ``cudaStreamSynchronize`` calls (the host waiting on
    the device: ``.item()``, ``nonzero``, boolean masks), and ``ops``, the
    calls of every ``aten::`` operator as the host recorded them (complete
    even where the device trace drops launches).  On the CPU the device
    rows are empty."""
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
    ops = {e.key: e.count for e in events if e.key.startswith("aten::")}
    return dict(wall_s=wall, busy_s=sum(r[1] for r in rows), rows=rows,
                syncs=syncs, ops=ops)


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls after
    one warm-up, by CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int, device) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls after
    one untimed warm-up (the first call on a card builds the kernels), by
    the host clock between two synchronisations of ``device``."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def timed(fn, device) -> tuple:
    """(``fn()``, its seconds by the host clock between two synchronisations
    of ``device``)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def host_us(fn, reps: int = 200) -> float:
    """Mean host microseconds of ``fn()`` over ``reps`` back-to-back calls
    after one warm-up, the device left to run behind: the queue is empty at
    the start and is waited for only after the clock stops, so this is what
    the call costs the host (checks, allocations, the launch), not what the
    kernel costs the device.  Keep ``reps`` below the launch queue's depth
    (about a thousand launches)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def _traced_rows(fn, device, n: int, keep, tries: int = 3) -> list:
    """The profiler's device rows ``(name, seconds, launches)`` that
    ``keep(name)`` selects, of ``n`` calls of ``fn`` after one warm-up.  The
    device trace records some launches, not all: on an H100 it missed the
    first launches of a fast loop, late in a long process it kept 8 of 20,
    and once it kept none, so the calls wait 50 ms first and a trace that
    kept none of the selected kernels is taken again, ``tries`` times in
    all."""

    def calls():
        time.sleep(0.05)
        for _ in range(n):
            fn()

    fn()
    for _ in range(tries):
        rows = [r for r in device_breakdown(calls, device)["rows"] if keep(r[0])]
        if rows:
            break
    return rows


def kernel_device_ms(fn, name: str, device, n: int = 20) -> float:
    """The profiler's device time per launch of the CUDA kernels whose name
    contains ``name``, averaged over the launches it recorded of ``n`` calls
    of ``fn`` (at least one must be recorded; ``_traced_rows``)."""
    rows = _traced_rows(fn, device, n, lambda key: name in key)
    count = sum(c for _, _, c in rows)
    if not 1 <= count <= n:
        raise RuntimeError(f"{name}: {count} launches recorded of {n}: {rows[:5]}")
    return sum(sec for _, sec, _ in rows) * 1e3 / count


def call_device_ms(fn, device, n: int = 20) -> float:
    """Device ms of one call of ``fn``, for a call that launches each of its
    CUDA kernels once (one PyTorch library call): the sum over its kernels
    of the profiler's mean time per recorded launch, which stays right when
    the device trace drops launches."""
    rows = _traced_rows(fn, device, n, lambda key: True)
    if not rows or any(cnt > n for _, _, cnt in rows):
        raise RuntimeError(f"not one launch per kernel and call: {rows[:5]}")
    return sum(sec / cnt for _, sec, cnt in rows) * 1e3


def covered(starts: torch.Tensor, lens: torch.Tensor, L: int) -> int:
    """The distinct rows of [0, L) that the windows [s, s + n) touch, each
    clamped to [0, L)."""
    s = starts.reshape(-1).long().clamp(0, L)
    n = torch.minimum(lens.reshape(-1).long().clamp_min(0), L - s)
    delta = torch.zeros(L + 1, dtype=torch.int64, device=s.device)
    delta.index_add_(0, s, torch.ones_like(s))
    delta.index_add_(0, s + n, -torch.ones_like(s))
    return int((torch.cumsum(delta, 0)[:L] > 0).sum())


def pairs_in_reach(pk, b_geo, spans, cfg, spec) -> int:
    """(query, lane) pairs of these inputs whose candidate lies within the
    support radius 2H of the query, r^2 < (2H)^2 in float32: the lanes whose
    term is not 0.  Counted over the lanes the kernels compute (the plain
    versions' own lane table), in the plain versions' chunks of blocks."""
    n_blocks, qb = spec.n_layout // spec.qb, spec.qb
    xy = torch.cat([pk[:, 0:2], b_geo[:, 0:2]])
    reach2 = (2.0 * cfg.h) ** 2
    step, pairs = wk._chunk(spec), 0
    for b0 in range(0, n_blocks, step):
        b1 = min(b0 + step, n_blocks)
        idx, valid = wk._span_lanes(spans, b0, b1, spec.cap, spec.n_layout,
                                    b_geo.shape[0])
        cand = xy[idx]                                      # (nb, lanes, 2)
        q = pk[b0 * qb:b1 * qb, 0:2].reshape(b1 - b0, qb, 1, 2)
        d = q - cand[:, None]
        near = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) < reach2
        pairs += int((near & valid[:, None, :]).sum())
    return pairs


def bound(nbytes: int, flops: int) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and ``flops`` float32 operations over the float32
    rate, and which of the two sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return dict(bytes=int(nbytes), flops=int(flops),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def trace(path: str):
    """Profile the block under ``torch.profiler`` (host operators, and the
    card's kernels where there is one) and write a Chrome trace to ``path``
    (`utils/profiling.py:25-32`).  Yields ``path``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def device_memory() -> dict:
    """Bytes in use, peak bytes in use (since the process started or the
    last ``torch.cuda.reset_peak_memory_stats``) and the card's total, per
    CUDA device by name (`utils/profiling.py:55-66`); ``{}`` without one."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return out


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
                 "r64": (eng.make_multi_step(resort_every=64, return_frame=True),
                         384 if n_target < 500_000 else 64, 64)}
        spread = {}
        for name, (multi, n, _) in cells.items():
            ps, t, times = throughput(multi, sim0, _gravity(n), fluid.n)
            spread[name] = dict(ticks=n, ms_per_tick=[x * 1e3 for x in times],
                                median_ms=t * 1e3, ps_per_s_median=ps)
        print(json.dumps({"n_fluid": fluid.n, "n_layout": eng.n_layout,
                          "L": eng.spec.L, **spread}), flush=True)
        for name, (multi, _, n) in cells.items():
            _print_breakdown(f"{fluid.n} {name}: {n} ticks", "tick", n,
                             device_breakdown(lambda: multi(sim0, _gravity(n)), dev))
        _print_span_build(eng, sim0, dev)
        sim, _, frame = cells["r64"][0](sim0, _gravity(64))
        for rows in (64, 256):
            rend = WindowRenderer(eng, rows, 128)
            rend.render_from_frame(sim, frame)
            b = device_breakdown(lambda: [rend.render_from_frame(sim, frame)
                                          for _ in range(N_FRAMES)], dev)
            _print_breakdown(f"{fluid.n} render_from_frame {rows}x128: "
                             f"{N_FRAMES} frames", "frame", N_FRAMES, b, FRAME_PARTS)


def _print_span_build(eng, sim, dev) -> None:
    """What feeds the window kernels, once per relayout: ``start_grid`` and
    ``block_spans`` on the primed state's own cells (event ms, device ms and
    launches)."""
    cfg, pk = eng.cfg, sim.packed
    cells = torch.where(pk[:, 4] > 0, cell_ids(pk[:, 0], pk[:, 1], cfg),
                        torch.full_like(pk[:, 4], cfg.n_cells, dtype=torch.int32))
    cell_starts = csr_starts(cells, cfg.n_cells + 2)
    row_shift = build_frame(eng.spec, cfg, cell_starts, eng.b_cell_starts)[2]

    def build():
        return block_spans(eng.spec, cfg, cells,
                           start_grid(cfg, cell_starts, row_shift), eng._b_grid)

    ms = event_ms(build, 20)
    b = device_breakdown(lambda: [build() for _ in range(20)], dev)
    print(f"== {eng.n_real} span build (start_grid + block_spans), per relayout: "
          f"{ms:.4f} ms by events, device {b['busy_s'] * 1e3 / 20:.4f} ms in "
          f"{sum(r[2] for r in b['rows']) / 20:.1f} launches", flush=True)


# device kernels by part, as substrings of their names: of a tick, and of a
# rendered frame (whose candidates nothing prepares: what is not the field
# kernel or the unsort of its output is the overflow count, the scale, the
# threshold and the page pack)
TICK_PARTS = (("window kernels", ("density_window_kernel", "forces_window_kernel")),
              ("row gathers (index_select, index)",
               ("index_select", "index_elementwise", "indexSelect", "gather")))
FRAME_PARTS = (("field kernel", ("field_window_kernel",)),
               ("unsort of the field (index)",
                ("index_select", "index_elementwise", "indexSelect", "gather")))


def _print_breakdown(title: str, unit: str, n: int, b: dict,
                     parts=TICK_PARTS) -> None:
    print(f"== {title}, traced wall {b['wall_s'] * 1e3 / n:.4f} ms/{unit}, "
          f"device busy {b['busy_s'] * 1e3 / n:.4f} ms/{unit} "
          f"({100 * b['busy_s'] / b['wall_s']:.1f}% of wall), "
          f"syncs/{unit} {b['syncs'] / n:.2f}", flush=True)
    rest_s, rest_n = b["busy_s"], sum(r[2] for r in b["rows"])
    for what, keys in parts:
        rows = [r for r in b["rows"] if any(k in r[0] for k in keys)]
        rest_s -= sum(r[1] for r in rows)
        rest_n -= sum(r[2] for r in rows)
        print(f"   {what}: {sum(r[1] for r in rows) * 1e3 / n:.4f} ms/{unit} in "
              f"{sum(r[2] for r in rows) / n:.2f} launches/{unit}", flush=True)
    print(f"   everything else: {rest_s * 1e3 / n:.4f} ms/{unit} in "
          f"{rest_n / n:.2f} launches/{unit}", flush=True)
    for key, s, count in b["rows"][:14]:
        print(f"   {s * 1e3 / n:8.4f} ms/{unit} {100 * s / b['busy_s']:5.1f}%"
              f"  x{count / n:5.2f}/{unit}  {key[:90]}", flush=True)


if __name__ == "__main__":
    main()
