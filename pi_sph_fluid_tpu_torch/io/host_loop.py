"""The host run loop: K device steps per dispatch, I/O at the edges (port of
`pi_sph_fluid_tpu/io/host_loop.py:31-670`: the window, slab-decomposition
and reference backends).

This replaces the reference's `main` loop (`pi_sph_fluid.c:610-703`): the
device advances K ticks per dispatch, gravity is sampled per batch (a (K, 2)
trace), one frame is rendered per dispatch from the engine's relayout frame
and pushed to a non-blocking sink one dispatch late, and pacing sleeps
instead of spinning.

Every loss channel stays counted: the render's window overflow folds into
``neighbor_overflow``; window overflow is answered by elastic cap recovery
(a 1.5x ladder, revert to the last clean report, replay the logged gravity
traces); a stale-drift trip halves ``resort_every`` and replays; clean
report intervals double it up to a ceiling pinned below any period that
tripped.  Under slab decomposition each capacity the loss names
(``StepStats.overflow_by``) grows on its own ladder, and a revert goes
through the domain's export and init, since the state's shapes change with
the capacities.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import SPHConfig
from ..models.boundary import prepare_boundary
from ..models.engine_v3 import WindowEngine
from ..models.simulation import (OVERFLOW_CATEGORIES, StepStats, make_multi_step,
                                 prime)
from ..parallel import DistComm, LocalComm, WindowDomain
from ..parallel.launch import is_multiprocess
from ..render.metaballs import make_renderer
from ..render.metaballs_window import WindowRenderer
from ..utils.stats import StatsReporter
from ..utils.tracer import tracer

__all__ = ["SimRunner", "RunResult"]


def _ladder_up(x: int, q: int) -> int:
    """One step of the capacity ladder: 1.5x rounded up to the q-quantum."""
    return -(-(x * 3 // 2) // q) * q


def _saturating_sum(a: torch.Tensor) -> torch.Tensor:
    """int32 sum taken in float32 and clamped at 1e9, so that a catastrophic
    state's 1e9-scale counts cannot wrap negative and hide the scream."""
    return torch.clamp_max(torch.sum(a.to(torch.float32)), 1e9).to(torch.int32)


def _reduce(st):
    """A dispatch's (K,) stats reduced on the device to scalars, and
    overflow_by to (4,) (`host_loop.py:306-329`)."""
    by = st.overflow_by
    if by is not None:
        by = torch.clamp_max(torch.sum(by.to(torch.float32), 0), 1e9).to(torch.int32)
    return type(st)(
        max_rho_error_pct=torch.max(st.max_rho_error_pct),
        max_speed=torch.max(st.max_speed),
        neighbor_overflow=_saturating_sum(st.neighbor_overflow),
        overflow_by=by,
        stale=None if st.stale is None else _saturating_sum(st.stale))


def _show(sink, frame, seq: int):
    """Hand dispatch ``seq``'s frame to the sink.  The copy to the host is
    stream-ordered: it waits for every launch queued before it."""
    with tracer.span("runner.frame_fetch", dispatch=seq):
        fb = frame.cpu().numpy()
    with tracer.span("runner.sink", dispatch=seq):
        sink.push(fb)


@dataclass
class RunResult:
    sim: object
    reporter: StatsReporter
    wall_s: float
    steps: int
    n_fluid: int = 0
    recoveries: int = 0   # elastic reverts taken (cap growth, stale downgrade)
    dispatches: int = 0   # dispatches run, replays included (one render each)

    @property
    def particle_steps_per_s(self) -> float:
        return self.n_fluid * self.steps / self.wall_s if self.wall_s else 0.0


class SimRunner:
    """Owns the engine and renderer for one scene on one device.

    backend: "window" (the window kernels on one device; the JAX package's
    "pallas"), "window-dd" (slab domain decomposition, parallel/
    domain_window.py, ``engine_opts["slabs"]`` slabs, default 1, all on the
    one device or this process's share of them under a process group; the
    JAX package's "pallas-dd") or "reference" (the jnp
    oracle, models/simulation.py: dense candidate windows, the oracle
    renderer, no resort ladder and no cap recovery, as in the JAX runner).
    """

    def __init__(
        self,
        cfg: SPHConfig,
        fluid,
        boundary_raw,
        backend: str = "window",
        engine_opts: dict | None = None,
        render: bool = True,
        render_shape: tuple[int, int] = (64, 128),
        resort_every: int = 1,
        auto_cap: bool = True,
        max_cap: int = 1024,
        max_resort: int | None = None,
        raise_after: int = 2,
        device="cuda",
    ):
        if backend not in ("window", "window-dd", "reference"):
            raise ValueError(f"unknown backend {backend!r}")
        if resort_every < 1:
            raise ValueError(f"resort_every must be >= 1, got {resort_every}")
        window = backend != "reference"
        self.cfg = cfg
        self.backend = backend
        self.device = torch.device(device)
        self.n_fluid = fluid.n
        self.boundary, self._bgrid = prepare_boundary(boundary_raw, cfg)
        self._fluid_init = fluid
        self._render = render
        self._render_shape = render_shape
        # the oracle relayouts every tick: no sticky period, no ladder, no
        # window cap to recover (`host_loop.py:98,109-110,140`)
        self._resort = resort_every if window else 1
        self.auto_cap = auto_cap and window
        self.max_cap = max_cap
        # upward resort ladder: after raise_after consecutive clean report
        # intervals the period doubles up to max_resort; a stale trip halves
        # it and pins the ceiling below the tripped period.  Off when None.
        self._max_resort = max_resort if window else None
        self._raise_after = max(1, int(raise_after))
        self._resort_ceiling = max_resort or 0
        self._engine_opts = dict(engine_opts or {})
        self.domain = None
        if backend == "window-dd":
            self._build_dd()
        elif window:
            self._build()
        else:
            self._build_reference()

    # ------------------------------------------------------------------
    def _next_cap(self, old: int) -> int:
        """Escalation ladder: 1.5x rounded up to the 128-lane quantum,
        bounded by max_cap."""
        return min(_ladder_up(old, 128), self.max_cap)

    def _build(self, cap: int | None = None):
        """(Re)build the engine, its multi-step and the renderer.  Called at
        construction and by recovery with a larger ``cap`` (kept for later
        rebuilds) or after a change of resort_every.  n_layout does not
        depend on cap, so a checkpointed PackedSim steps under the new
        engine unchanged."""
        if cap is not None:
            self._engine_opts["cap"] = cap
        with tracer.span("runner.build", cap=self._engine_opts.get("cap"),
                         resort=self._resort):
            self.engine = WindowEngine(self.cfg, self.boundary, self._bgrid,
                                       self.n_fluid, self.device, **self._engine_opts)
            self._multi = self.engine.make_multi_step(resort_every=self._resort,
                                                      return_frame=self._render)
            self._settle_multi = self.engine.make_multi_step(damping=0.995)
            self._renderer = (WindowRenderer(self.engine, *self._render_shape)
                              .render_from_frame if self._render else None)

    def _dd_growth(self, cats: set) -> dict:
        """The capacity growth for the starved categories (names of
        OVERFLOW_CATEGORIES), each on its own 1.5x ladder with a ceiling
        (`host_loop.py:175-207`): window at max_cap, halo and migration at
        the slab cap (their rows are a slab's), slab at the whole fluid.  A
        category at its ceiling is left out, so repeated recovery ends: an
        empty proposal means the run goes on with counted losses."""
        d = self.domain
        grow = {}
        if "window" in cats:
            nc = self._next_cap(d.spec.cap)
            if nc > d.spec.cap:
                grow["cap"] = nc
        edge_bound = -(-d.slab_cap // 64) * 64
        if "halo" in cats:
            nh = min(_ladder_up(d.halo_cap, 64), edge_bound)
            if nh > d.halo_cap:
                grow["halo_cap"] = nh
        if "mig" in cats:
            nm = min(_ladder_up(d.mig_cap, 64), edge_bound)
            if nm > d.mig_cap:
                grow["mig_cap"] = nm
        if "slab" in cats:
            ns = min(_ladder_up(d.slab_cap, 128),
                     -(-(self.n_fluid + 64) // 128) * 128)
            if ns > d.slab_cap:
                grow["slab_cap"] = ns
        return grow

    def _build_dd(self, grow: dict | None = None):
        """(Re)build the slab decomposition (`host_loop.py:209-248`): a
        ``WindowDomain`` on the runner's device over ``DistComm(slabs)``
        when a process group is up (parallel/launch.py; this process holds
        its share of the slabs) and over ``LocalComm(slabs)`` otherwise,
        its sticky multi-step, a damped exact settle multi-step and the
        per-slab renderer.  ``grow`` (from _dd_growth) overrides capacities
        and is kept for later rebuilds; every process rebuilds alike, since
        every recovery decision is taken on stats reduced over all slabs."""
        if grow:
            self._engine_opts.update(grow)
        opts = dict(self._engine_opts)
        slabs = opts.pop("slabs", None) or 1
        self.engine = None
        with tracer.span("runner.build", cap=opts.get("cap"), resort=self._resort):
            comm = DistComm(slabs) if is_multiprocess() else LocalComm(slabs)
            self.domain = WindowDomain(self.cfg, self.boundary, self._bgrid,
                                       self.n_fluid, comm, self.device, **opts)
            self._multi = self._wrap_dd(self.domain.make_multi_step(
                resort_every=self._resort))
            self._settle_multi = self._wrap_dd(self.domain.make_multi_step(damping=0.995))
            self._renderer = None
            if self._render:
                render = self.domain.make_render(*self._render_shape)
                self._renderer = lambda sim, frame: render(sim)

    def _wrap_dd(self, dmulti):
        """A WindowDomain multi-step with its stats dict as StepStats
        (`host_loop.py:250-269`): a particle lost (n_valid short of the
        fluid at the last tick) screams x1e6 in every tick's overflow, as in
        JAX, summed without wrapping."""
        n_fluid = self.n_fluid

        def multi(state, g_trace):
            state, st = dmulti(state, g_trace)
            lost = torch.clamp_min(n_fluid - st["n_valid"][-1].to(torch.int64), 0)
            ov = st["overflow"].to(torch.int64) + lost * 1_000_000
            return state, StepStats(
                max_rho_error_pct=st["max_rho_error_pct"],
                max_speed=st["max_speed"],
                neighbor_overflow=torch.clamp_max(ov, (1 << 31) - 1).to(torch.int32),
                overflow_by=st["overflow_by"], stale=st.get("stale"))

        return multi

    def _rebuild(self):
        """Rebuild the backend's pipeline after a change of resort_every."""
        if self.domain is not None:
            self._build_dd()
        else:
            self._build()

    def _build_reference(self):
        """The jnp-oracle pipeline (`host_loop.py:133-138,298-300`): prime,
        multi-step and damped settle of models/simulation.py, and the oracle
        renderer on the state's fluid view, which loses no pixel pairs
        (overflow 0)."""
        self.engine = None
        cfg, b, bg = self.cfg, self.boundary, self._bgrid
        with tracer.span("runner.build", cap=None, resort=self._resort):
            self._multi = make_multi_step(cfg, b, bg)
            self._settle_multi = make_multi_step(cfg, b, bg, damping=0.995)
            self._renderer = None
            if self._render:
                render = make_renderer(cfg, *self._render_shape)
                zero = torch.zeros((), dtype=torch.int32, device=self.device)
                self._renderer = lambda sim, frame: (render(sim.fluid), zero)

    @tracer.traced("runner.prime")
    def _prime(self, g):
        if self.domain is not None:
            return self.domain.init(self._fluid_init)
        if self.engine is None:
            return prime(self._fluid_init, self.boundary, self._bgrid, g, self.cfg)
        return self.engine.prime(self._fluid_init, g)

    def _dispatch(self, sim, g_trace):
        """K ticks, then (with a renderer) one frame from the engine's last
        relayout (the oracle and the slab decomposition render the state
        itself); stats reduced on the device, render overflow folded in.
        One span, under a new dispatch number."""
        with tracer.span("runner.dispatch", dispatch=tracer.next_dispatch()):
            if self._renderer is None:
                sim, st = self._multi(sim, g_trace)
                return sim, _reduce(st), None
            if self.engine is None:
                (sim, st), frame = self._multi(sim, g_trace), None
            else:
                sim, st, frame = self._multi(sim, g_trace)
            fb, render_overflow = self._renderer(sim, frame)
            st = _reduce(st)
            st = st._replace(neighbor_overflow=st.neighbor_overflow + render_overflow)
            return sim, st, fb

    # ------------------------------------------------------------------
    @tracer.traced("runner.run")
    def run(
        self,
        gravity_source,
        sink=None,
        sim_seconds: float = 1.0,
        realtime: bool = False,
        steps_per_dispatch: int | None = None,
        report_stream=None,
        settle_seconds: float = 0.0,
        resume=None,
        report_every: float = 0.1,
    ) -> RunResult:
        """Run ``sim_seconds`` of simulation.  ``resume`` continues from a
        previous RunResult.sim instead of priming the scene."""
        cfg = self.cfg
        dt = cfg.dt
        # default batch: one 60 Hz display frame of ticks (`pi_sph_fluid.c:648`),
        # or a whole report interval headless
        if steps_per_dispatch:
            k = steps_per_dispatch
        elif self._renderer is not None:
            k = max(1, int(round(1.0 / (60.0 * dt))))
        else:
            k = max(1, int(round(0.1 / dt)))
        k = -(-k // self._resort) * self._resort
        n_dispatch = max(1, int(round(sim_seconds / (k * dt))))
        g_init = gravity_source.current()

        def say(msg):
            if report_stream is not None:
                print(msg, file=report_stream, flush=True)

        def start():
            """Prime (+ damped settle); returns (sim, settle overflow), the
            overflow drained once at the end, not per chunk."""
            sim = resume if resume is not None else self._prime(g_init)
            if settle_seconds <= 0.0:
                return sim, 0
            with tracer.span("runner.settle"):
                # damped pre-roll in k-tick chunks, rounded up
                n_settle = int(round(settle_seconds / dt))
                g0 = np.tile(np.asarray(g_init, np.float32), (k, 1))
                pending = []
                for _ in range(-(-n_settle // k)):
                    sim, st = self._settle_multi(sim, g0)
                    pending.append(st.neighbor_overflow.sum(dtype=torch.int64))
                ov = int(torch.stack(pending).sum().item()) if pending else 0
            return sim, ov

        use_ac = self.auto_cap
        recoveries = 0

        def growing(grow):
            return ", ".join(f"{key} -> {val}" for key, val in sorted(grow.items()))

        def start_recovered():
            """start() with settle-overflow recovery: grow the capacities on
            their ladders and redo prime + settle until the pre-roll is
            clean or the ceilings are hit.  Used at run start and on a
            revert-to-start."""
            nonlocal use_ac, recoveries
            sim, settle_ov = start()
            while use_ac and settle_ov > 0:
                if self.domain is not None:
                    # the settle drains only the total: grow every capacity
                    grow = self._dd_growth(set(OVERFLOW_CATEGORIES))
                    if not grow:
                        use_ac = False
                        say("OVERFLOW during settle with every capacity at its "
                            "ceiling: continuing with losses")
                        break
                    say(f"OVERFLOW during settle: growing {growing(grow)}, "
                        f"restarting settle")
                    self._build_dd(grow)
                    recoveries += 1
                    sim, settle_ov = start()
                    continue
                old_cap = self.engine.spec.cap
                new_cap = self._next_cap(old_cap)
                if new_cap <= old_cap:
                    use_ac = False
                    say(f"WINDOW OVERFLOW during settle at cap={old_cap} "
                        f"(max-cap reached): continuing with lost pairs")
                    break
                say(f"WINDOW OVERFLOW during settle: cap {old_cap} -> "
                    f"{new_cap}, restarting settle")
                self._build(cap=new_cap)
                recoveries += 1
                sim, settle_ov = start()
            return sim

        sim = start_recovered()
        reporter = StatsReporter(dt=dt, stream=report_stream,
                                 report_every_sim_s=report_every)
        g_const = (gravity_source.trace(k, dt)
                   if getattr(gravity_source, "is_constant", False) else None)
        # recovery checkpoint: (state, position, reporter aggregates) at the
        # last clean report; gravity sources are stateful, so every trace
        # issued since the checkpoint is logged for an exact replay
        ck_sim, ck_i, ck_t = sim, 0, 0.0
        ck_rep = reporter.snapshot()
        ck_is_start = resume is None   # the prime (and settle) ran under the
        # old engine too, so a revert-to-start redoes them
        g_log: list = []
        replay_pos = 0
        clean_streak = 0
        t0 = time.perf_counter()
        t_mono0 = time.monotonic()
        sim_t = 0.0
        # displayed one dispatch late: frame i-1 is fetched after dispatch i
        # is queued (the reference's tearing-tolerant display contract)
        pending_frame, pending_seq = None, -1

        def lost() -> int:
            """The ticks a revert throws away: those run since the checkpoint,
            replays included; counted in runner.ticks_reverted."""
            ticks = (i - ck_i) * k
            tracer.count("runner.ticks_reverted", ticks)
            return ticks

        def revert():
            nonlocal sim, i, sim_t, replay_pos, pending_frame, recoveries
            nonlocal clean_streak, t_mono0
            sim, i, sim_t = ck_sim, ck_i, ck_t
            reporter.restore(ck_rep)
            replay_pos = 0
            pending_frame = None
            recoveries += 1
            clean_streak = 0
            t_mono0 = time.monotonic() - sim_t

        tracer.count("runner.ticks_reverted", 0)   # 0 on a run without reverts
        i = dispatches = 0
        while i < n_dispatch:
            if g_const is not None:
                g_trace = g_const
            elif replay_pos < len(g_log):
                g_trace = g_log[replay_pos]
                replay_pos += 1
            else:
                g_trace = gravity_source.trace(k, dt)
                g_log.append(g_trace)
                replay_pos = len(g_log)
            sim, st, frame = self._dispatch(sim, g_trace)
            dispatches += 1
            if frame is not None and sink is not None:
                if pending_frame is not None:
                    _show(sink, pending_frame, pending_seq)
                pending_frame, pending_seq = frame, tracer.last_dispatch
            line = reporter.update(k, st)
            sim_t += k * dt
            i += 1
            if use_ac and (line is not None or i == n_dispatch):
                # the checks ride the report cadence (plus end of run), where
                # the reporter drains anyway: no extra host syncs
                if reporter.total_overflow > 0 and self.domain is not None:
                    # grow exactly the capacities the attribution names; a
                    # scream with no capacity loss (non-finite rows, lost
                    # particles) names none, so grow them all
                    by = reporter.total_overflow_by
                    cats = (set(OVERFLOW_CATEGORIES) if by is None or int(by.sum()) == 0
                            else {c for c, n in zip(OVERFLOW_CATEGORIES, by) if n > 0})
                    grow = self._dd_growth(cats)
                    if not grow:
                        use_ac = False
                        say(f"OVERFLOW in {sorted(cats)} with every starved "
                            f"capacity at its ceiling: continuing with losses")
                        continue
                    with tracer.span("runner.recover", cause="dd_growth", ticks=lost()):
                        say(f"OVERFLOW in {sorted(cats)}: growing {growing(grow)}, "
                            f"reverting to t={ck_t:.2f}s and replaying")
                        if ck_is_start:
                            self._build_dd(grow)
                            ck_sim = start_recovered()
                        else:
                            # the slab arrays change shape with the capacities:
                            # the checkpoint goes through the lossless export
                            ck_export = self.domain.export(ck_sim)
                            self._build_dd(grow)
                            ck_sim = self.domain.init(*ck_export)
                        revert()
                    continue
                if reporter.total_overflow > 0:
                    old_cap = self.engine.spec.cap
                    new_cap = self._next_cap(old_cap)
                    if new_cap <= old_cap:
                        use_ac = False
                        say(f"WINDOW OVERFLOW at cap={old_cap} (max-cap "
                            f"reached): continuing with lost pairs")
                        continue
                    with tracer.span("runner.recover", cause="cap_growth", ticks=lost()):
                        say(f"WINDOW OVERFLOW: cap {old_cap} -> {new_cap}, "
                            f"reverting to t={ck_t:.2f}s and replaying")
                        self._build(cap=new_cap)
                        if ck_is_start:
                            ck_sim = start_recovered()
                        revert()
                    continue
                if reporter.total_stale > 0 and self._resort > 1:
                    # stale downgrade: drift passed the 0.3*H margin inside a
                    # sticky group; the cure is a fresher layout: halve
                    # resort_every, revert, replay (ends at 1: exact mode has
                    # no carried ticks)
                    new_resort = self._resort // 2
                    with tracer.span("runner.recover", cause="stale", ticks=lost()):
                        say(f"STALE DRIFT: {reporter.total_stale} particle-ticks "
                            f"past the fringe margin; resort_every {self._resort} "
                            f"-> {new_resort}, reverting to t={ck_t:.2f}s and "
                            f"replaying")
                        self._resort = new_resort
                        # a period that tripped is never re-entered by the ladder
                        self._resort_ceiling = min(self._resort_ceiling, new_resort)
                        self._rebuild()
                        if ck_is_start:
                            ck_sim = start_recovered()
                        revert()
                    continue
                if line is not None:
                    ck_sim, ck_i, ck_t = sim, i, sim_t
                    ck_rep = reporter.snapshot()
                    ck_is_start = False
                    # keep the not-yet-replayed suffix: the source's clock has
                    # already consumed those ticks
                    g_log = g_log[replay_pos:]
                    replay_pos = 0
                    clean_streak += 1
                    # upward resort ladder (`host_loop.py:635-656`): not under
                    # realtime pacing, and only to a period that divides k
                    if (self._max_resort and not realtime and self._resort > 1
                            and clean_streak >= self._raise_after
                            and i < n_dispatch):
                        new_r = self._resort * 2
                        if new_r <= self._resort_ceiling and k % new_r == 0:
                            say(f"RESORT LADDER: {clean_streak} clean intervals; "
                                f"resort_every {self._resort} -> {new_r}")
                            self._resort = new_r
                            clean_streak = 0
                            self._rebuild()
            if realtime:
                # pacing to the sim-time deadline (the reference's REALTIME
                # spin-wait, `pi_sph_fluid.c:694-701`, as sleep + spin)
                from .native import pace_until

                pace_until(t_mono0 + sim_t)
        if pending_frame is not None and sink is not None:
            _show(sink, pending_frame, pending_seq)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        return RunResult(sim=sim, reporter=reporter, wall_s=wall,
                         steps=k * n_dispatch, n_fluid=self.n_fluid,
                         recoveries=recoveries, dispatches=dispatches)
