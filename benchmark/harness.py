"""One run of one cell: set-up, the measured window through the port's
served path, the metrics, and the check that decides `correct`.

The window drives ``io.host_loop.SimRunner.run``, built as the port's
``cli.py run`` builds it.  ``run`` takes a length in sim time and cannot be
stopped on wall time from outside, so the window calls it in chunks of the
traffic's ``chunk_dispatches`` dispatches with ``resume=``, on the same
runner, until the first chunk boundary after ``--seconds``.  Each chunk is a whole served
run: its dispatches, its frames one dispatch late, its cap recovery and
resort ladder, its synchronisation at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import sys
import time

import numpy as np
import torch

import pi_sph_fluid_tpu_torch as port
from pi_sph_fluid_tpu_torch.io import gravity as port_gravity
from pi_sph_fluid_tpu_torch.io.host_loop import SimRunner
from pi_sph_fluid_tpu_torch.state import BoundaryState, FluidState

from . import check, roofline
from . import trace as tr
from .reference import Physics, Reference
from .scene import build_scene, rng
from .sink import TimingSink
from .traffic import make_gravity

__all__ = ["Run", "run_cell", "FORBIDDEN"]

# top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pi_sph_fluid_tpu")


def port_config(cfg: dict):
    """The port's SPHConfig from a configuration file's physics keys."""
    fields = {f.name for f in dataclasses.fields(port.SPHConfig)}
    return port.SPHConfig(**{k: v for k, v in cfg.items() if k in fields})


def program_rows(sim) -> dict:
    """A state of the port (a PackedSim: packed rows [x, y, u, v, m, rho, p,
    id], ids, au, av) as id-ordered tensors of its real particles."""
    live = sim.ids >= 0
    ids = sim.ids[live].long()
    inv = torch.empty_like(ids)
    inv[ids] = torch.arange(ids.shape[0], device=ids.device)
    rows = torch.nonzero(live).reshape(-1)[inv]
    pk = sim.packed[rows]
    return dict(x=pk[:, 0], y=pk[:, 1], u=pk[:, 2], v=pk[:, 3], rho=pk[:, 5],
                au=sim.au[rows], av=sim.av[rows])


class DispatchLog:
    """Wraps the runner's ``_dispatch`` to see every dispatch of the window:
    its ticks, its reduced loss counts, which dispatch's output it started
    from (so that the committed chain is known after reverts), and a seeded
    sample of whole dispatches (input, gravity, output, frame or None
    headless) for the check.
    It holds references only: the port makes new tensors each dispatch."""

    def __init__(self, runner, keep: int, seed: int):
        self.recording = False
        self.parent: list = []
        self.ticks: list = []
        self.losses: list = []
        self.sample: list = []      # reservoir of (seq, in, g, out, fb)
        self.primed = None          # the prime's state and its gravity
        self._keep = keep
        self._rng = rng(seed, 2)
        dispatch, prime = runner._dispatch, runner._prime

        def logged_dispatch(sim, g_trace):
            out = dispatch(sim, g_trace)
            if self.recording:
                self._record(sim, g_trace, out)
            return out

        def logged_prime(g):
            sim = prime(g)
            if self.primed is None:
                self.primed = (sim, tuple(float(v) for v in np.asarray(g)))
            return sim

        runner._dispatch = logged_dispatch
        runner._prime = logged_prime

    def _record(self, sim, g_trace, out):
        seq = len(self.parent)
        self.parent.append(getattr(sim.packed, "_bench_seq", -1))
        out[0].packed._bench_seq = seq
        self.ticks.append(int(len(g_trace)))
        st = out[1]
        stale = st.stale if st.stale is not None else torch.zeros_like(st.neighbor_overflow)
        self.losses.append(torch.stack([st.neighbor_overflow.to(torch.int64),
                                        stale.to(torch.int64)]))
        item = (seq, sim, np.array(g_trace, np.float32), out[0], out[2])
        if len(self.sample) < self._keep:
            self.sample.append(item)
        else:
            j = int(self._rng.integers(0, seq + 1))
            if j < self._keep:
                self.sample[j] = item

    def committed(self, final_sim) -> list:
        """The dispatches whose outputs the window kept, in order."""
        seq = getattr(final_sim.packed, "_bench_seq", -1)
        chain = []
        while seq >= 0:
            chain.append(seq)
            seq = self.parent[seq]
        return chain[::-1]


@dataclasses.dataclass
class Run:
    """What the metric readers read of one run."""

    phys: Physics
    n_fluid: int
    setup_s: float
    window_s: float
    ticks_run: int
    ticks_committed: int
    frame_times: list
    trace: object            # trace.Trace of the traced window, or None
    final: dict              # the window's last state, id order
    walls: tuple             # the scene's wall positions, on the device

    @functools.cached_property
    def pairs(self) -> dict:
        """The pairs within 2H on the window's last state (roofline.pair_counts)."""
        return roofline.pair_counts(self.final["x"], self.final["y"], *self.walls,
                                    self.phys.support, (self.phys.width, self.phys.height))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _inputs(cfg: dict, scene: dict, pcfg, dev):
    """The scene as the port's FluidState and raw BoundaryState."""
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    n, nb = len(scene["fluid_x"]), len(scene["wall_x"])
    z, zb = torch.zeros(n, device=dev), torch.zeros(nb, device=dev)
    fluid = FluidState(x=t(scene["fluid_x"]), y=t(scene["fluid_y"]), u=z, v=z,
                       m=torch.full((n,), pcfg.particle_mass, device=dev),
                       rho=torch.full((n,), float(cfg["rho_0"]), device=dev), p=z)
    walls = BoundaryState(x=t(scene["wall_x"]), y=t(scene["wall_y"]), u=zb, v=zb,
                          m=zb, rho=torch.full((nb,), float(cfg["rho_0"]), device=dev))
    return fluid, walls


def run_cell(cfg: dict, traffic: dict, metrics: list, readers: dict,
             seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False, log=print) -> dict:
    """One run: returns the result line's fields and, under ``check``, each
    number compared with its limit (and with ``control`` the bfloat16
    reference's numbers on the same dispatches).  ``metrics`` are the
    BENCHMARK.json entries this run reports and ``readers`` their read
    functions by name."""
    dev = torch.device(device)
    pcfg = port_config(cfg)
    phys = Physics(cfg)
    scene = build_scene(cfg, seed)
    if len(scene["fluid_x"]) != cfg["n_fluid"] or len(scene["wall_x"]) != cfg["n_walls"]:
        raise ValueError(f"scene has {len(scene['fluid_x'])} fluid and "
                         f"{len(scene['wall_x'])} wall particles, the configuration "
                         f"states {cfg['n_fluid']} and {cfg['n_walls']}")
    fluid, walls_raw = _inputs(cfg, scene, pcfg, dev)
    gravity = make_gravity(traffic, seed, port_gravity, pcfg)
    if traffic["config"] != cfg["name"]:
        raise ValueError(f"the traffic is for {traffic['config']!r}, not {cfg['name']!r}")
    # a render_shape of null is a headless run, as `cli.py run --display none`
    shape = tuple(traffic["render_shape"]) if traffic["render_shape"] else None
    view = dict(render=True, render_shape=shape) if shape else dict(render=False)
    k = traffic["steps_per_dispatch"]
    # a chunk's length in sim time: chunk_dispatches dispatches of the K the
    # runner takes (steps_per_dispatch, or one 60 Hz frame of ticks, or
    # headless one 0.1 s report interval, rounded up to the resort period)
    k0 = k or max(1, int(round((1.0 / 60.0 if shape else 0.1) / pcfg.dt)))
    k_nom = -(-k0 // traffic["resort_every"]) * traffic["resort_every"]
    chunk_s = traffic["chunk_dispatches"] * k_nom * pcfg.dt
    spans = tr.install_spans(port) if trace else contextlib.nullcontext()
    with spans:
        runner = SimRunner(pcfg, fluid, walls_raw, backend="window",
                           engine_opts={"cap": traffic["cap"]}, **view,
                           resort_every=traffic["resort_every"],
                           auto_cap=traffic["auto_cap"], max_cap=traffic["max_cap"],
                           max_resort=traffic["max_resort"] or None, device=dev)
        dlog = DispatchLog(runner, traffic["check"]["dispatches"], seed)
        sink = TimingSink(span=trace)
        # the runner's report lines, as `cli.py run` streams them
        report = io.StringIO()

        def log_report(tag):
            """The report's event lines (recoveries, the ladder), not its
            periodic stats, to standard error."""
            for line in report.getvalue().splitlines():
                if not line.startswith("sim time"):
                    log(f"{tag}: {line}", file=sys.stderr)

        # set-up: prime, the runner's damped settle (settle_s), then the
        # pre-roll (or one chunk) through the same runner, which builds the
        # kernels and warms every shape of the cell
        res = runner.run(gravity, sink, sim_seconds=max(traffic["preroll_s"], chunk_s),
                         steps_per_dispatch=k, report_stream=report,
                         settle_seconds=traffic["settle_s"])
        _sync(dev)
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s: {res.steps} ticks, {res.dispatches} "
            f"dispatches, {res.recoveries} recoveries, worst speed "
            f"{res.reporter.worst_speed:.3f} m/s", file=sys.stderr)
        win = min(seconds, traffic["trace_s"]) if trace else seconds
        chunks, ends = [], []

        def window():
            t0 = time.perf_counter()
            sim = res.sim
            while True:
                r = runner.run(gravity, sink, sim_seconds=chunk_s,
                               steps_per_dispatch=k, resume=sim, report_stream=report)
                sim = r.sim
                chunks.append(r)
                ends.append(time.perf_counter() - t0)
                if time.perf_counter() - t0 >= win:
                    return sim, time.perf_counter() - t0

        log_report("runner (set-up)")
        report.seek(0)
        report.truncate()
        dlog.recording = sink.recording = True
        tdata = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function("bench.window"):
                    sim, window_s = window()
            t_read = time.perf_counter()
            tdata = tr.Trace.from_events(prof.profiler.kineto_results.events())
            del prof
            log(f"trace: {len(tdata.names)} device operations, {tdata.unlinked} "
                f"without a launching call, read in {time.perf_counter() - t_read:.1f} s",
                file=sys.stderr)
        else:
            sim, window_s = window()
        dlog.recording = sink.recording = False
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    committed = dlog.committed(sim)
    losses = (torch.stack(dlog.losses).cpu().numpy() if dlog.losses
              else np.zeros((0, 2), np.int64))
    attempted = len(committed)
    failed = int(sum(1 for s in committed if losses[s].max() > 0))
    ticks_committed = sum(r.steps for r in chunks)
    ticks_run = sum(dlog.ticks)
    wall_xy = (torch.as_tensor(scene["wall_x"], device=dev),
               torch.as_tensor(scene["wall_y"], device=dev))
    run = Run(phys=phys, n_fluid=fluid.n,
              setup_s=setup_s, window_s=window_s, ticks_run=ticks_run,
              ticks_committed=ticks_committed, frame_times=list(sink.times),
              trace=tdata, final=program_rows(sim), walls=wall_xy)
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    log(f"window {window_s:.3f} s: {ticks_run} ticks run, {ticks_committed} "
        f"committed, {len(dlog.parent)} dispatches, {attempted} committed, "
        f"{sum(r.recoveries for r in chunks)} recoveries, {len(sink.times)} frames, "
        f"worst speed {max(r.reporter.worst_speed for r in chunks):.3f} m/s", file=sys.stderr)
    gaps = np.diff([0.0] + ends)
    log("chunks (ticks/s): " + " ".join(f"{r.steps / t:.0f}" for r, t in zip(chunks, gaps)),
        file=sys.stderr)
    log_report("runner")

    traced = {}
    if tdata is not None:
        traced = dict(busy_s=tdata.busy_ns() * 1e-9, window_s=tdata.window_ns * 1e-9,
                      breakdown=tdata.breakdown())

    # the program's outputs to be judged, as plain tensors; then the
    # program's state is freed before the reference runs
    keep = set(committed)
    picked = [it for it in dlog.sample if it[0] in keep]
    checks = [dict(inp=program_rows(s_in), g=g, out=program_rows(s_out),
                   fb=None if fb is None else fb.clone())
              for _, s_in, g, s_out, fb in picked]
    primed, g0 = program_rows(dlog.primed[0]), dlog.primed[1]
    walls_prog = (runner.boundary.x, runner.boundary.y, runner.boundary.m)
    del runner, dlog, res, chunks, sim, run, tdata, fluid
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = Reference(phys, scene["wall_x"], scene["wall_y"], dev)
    xy = (scene["fluid_x"], scene["fluid_y"])
    rows = [check.start_numbers(ref, xy, g0, primed, walls_prog)]
    ctl_rows = []
    ctl = Reference(phys, scene["wall_x"], scene["wall_y"], dev, dtype=torch.bfloat16) if control else None
    if ctl is not None:
        ctl.prime(*xy, g0)
        ctl_rows.append(check.start_numbers(
            ref, xy, g0, dict(rho=ctl.rho, au=ctl.au, av=ctl.av), (ctl.bx, ctl.by, ctl.psi)))
    for c in checks:
        ref_out, ref_fb = check.reference_outputs(ref, c["inp"], c["g"], shape)
        rows.append(check.dispatch_numbers(c["inp"], c["out"], c["fb"], ref_out, ref_fb, phys))
        if ctl is not None:
            ctl_out, ctl_fb = check.reference_outputs(ctl, c["inp"], c["g"], shape)
            ctl_rows.append(check.dispatch_numbers(c["inp"], ctl_out, ctl_fb, ref_out, ref_fb, phys))
    # a committed dispatch with losses the runner did not recover is a
    # wrong answer whether or not the sample reached it: an exact count
    numbers = dict(check.worst(rows), failed=float(failed))
    log(f"check: {len(checks)} dispatches of {attempted} committed, "
        f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    limits = dict(traffic["check"]["limits"], failed=0)
    out = dict(correct=check.verdict(numbers, limits), attempted=attempted,
               failed=failed, metrics=values, peak=int(peak),
               numbers=numbers, limits=limits, checked=len(checks),
               check_s=time.perf_counter() - t_check)
    out.update(traced)
    if control:
        out["control"] = check.worst(ctl_rows)
    return out

