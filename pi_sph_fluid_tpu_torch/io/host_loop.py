"""The host run loop: K device steps per dispatch, I/O at the edges (port of
`pi_sph_fluid_tpu/io/host_loop.py:31-670`: the window, slab-decomposition
and reference backends).

This replaces the reference's `main` loop (`pi_sph_fluid.c:610-703`): the
device advances K ticks per dispatch, gravity is sampled per batch (a (K, 2)
trace), one frame is rendered per dispatch from the engine's relayout frame
and pushed to a non-blocking sink one dispatch late, and pacing sleeps
instead of spinning.

Every loss channel stays counted: the render's window overflow folds into
``neighbor_overflow``; overflow is answered by elastic capacity recovery
(each starved capacity on its 1.5x ladder, revert to the last clean report,
replay the logged gravity traces); a stale-drift trip halves
``resort_every`` and replays; clean report intervals double it up to a
ceiling pinned below any period that tripped.  The single engine's one
capacity is its window cap; under slab decomposition each capacity the loss
names (``StepStats.overflow_by``) grows on its own ladder, and a revert goes
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

__all__ = ["SimRunner", "RunResult", "grow_capacities"]


def _ladder_up(x: int, q: int) -> int:
    """One step of the capacity ladder: 1.5x rounded up to the q-quantum."""
    return -(-(x * 3 // 2) // q) * q


def grow_capacities(caps: dict, cats, max_cap: int, n_fluid: int) -> dict:
    """The growth of the starved capacities (``cats``, names of
    OVERFLOW_CATEGORIES), each on its own 1.5x ladder with a ceiling
    (`host_loop.py:144-207`).  ``caps`` holds the backend's capacities: the
    window ``cap`` (quantum 128, ceiling ``max_cap``) alone for the single
    engine; the slab domain adds ``halo_cap`` and ``mig_cap`` (quantum 64,
    ceiling the slab cap rounded to 64: their rows are a slab's) and
    ``slab_cap`` (quantum 128, ceiling the whole fluid plus 64, rounded to
    128).  A category with no capacity in ``caps``, or at its ceiling, is
    left out, so repeated recovery ends: an empty proposal means the run
    goes on with counted losses."""
    ladders = {"window": ("cap", 128, max_cap)}
    if "slab_cap" in caps:
        edge = -(-caps["slab_cap"] // 64) * 64
        ladders.update(halo=("halo_cap", 64, edge), mig=("mig_cap", 64, edge),
                       slab=("slab_cap", 128, -(-(n_fluid + 64) // 128) * 128))
    grow = {}
    for cat in OVERFLOW_CATEGORIES:
        if cat in cats and cat in ladders:
            key, q, ceiling = ladders[cat]
            new = min(_ladder_up(caps[key], q), ceiling)
            if new > caps[key]:
                grow[key] = new
    return grow


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


def _no_frame(multi):
    """A ``(sim, stats)`` multi-step as ``(sim, stats, None)``: its backend
    renders the state itself, from no relayout frame."""
    def with_none(sim, g_trace):
        return (*multi(sim, g_trace), None)

    return with_none


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
        self.engine = self.domain = None
        if window:
            self._build()
        else:
            self._build_reference()

    # ------------------------------------------------------------------
    def _build(self, grow: dict | None = None):
        """(Re)build the window backend, its sticky multi-step
        ``(sim, stats, frame)``, a damped exact settle multi-step and the
        renderer ``(sim, frame) -> (framebuffer, overflow)``: at
        construction, after a change of resort_every, and with the ``grow``
        of grow_capacities (kept in ``engine_opts`` for later rebuilds).
        "window" builds a ``WindowEngine`` (n_layout does not depend on cap,
        so a checkpointed PackedSim steps under the new engine unchanged);
        "window-dd" a ``WindowDomain`` (`host_loop.py:209-248`) over
        ``DistComm(slabs)`` when a process group is up (this process holds
        its share of the slabs), else ``LocalComm(slabs)``; every process
        rebuilds alike, since every recovery decision is taken on stats
        reduced over all slabs."""
        if grow:
            self._engine_opts.update(grow)
        opts = dict(self._engine_opts)
        with tracer.span("runner.build", cap=opts.get("cap"), resort=self._resort):
            if self.backend == "window":
                self.engine = WindowEngine(self.cfg, self.boundary, self._bgrid,
                                           self.n_fluid, self.device, **opts)
                self._multi = self.engine.make_multi_step(resort_every=self._resort,
                                                          return_frame=True)
                self._settle_multi = self.engine.make_multi_step(damping=0.995)
                self._renderer = (WindowRenderer(self.engine, *self._render_shape)
                                  .render_from_frame if self._render else None)
                return
            slabs = opts.pop("slabs", None) or 1
            comm = DistComm(slabs) if is_multiprocess() else LocalComm(slabs)
            self.domain = WindowDomain(self.cfg, self.boundary, self._bgrid,
                                       self.n_fluid, comm, self.device, **opts)
            self._multi = _no_frame(self._wrap_dd(self.domain.make_multi_step(
                resort_every=self._resort)))
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

    def _build_reference(self):
        """The jnp-oracle pipeline (`host_loop.py:133-138,298-300`): prime,
        multi-step and damped settle of models/simulation.py, and the oracle
        renderer on the state's fluid view, which loses no pixel pairs
        (overflow 0)."""
        cfg, b, bg = self.cfg, self.boundary, self._bgrid
        with tracer.span("runner.build", cap=None, resort=self._resort):
            self._multi = _no_frame(make_multi_step(cfg, b, bg))
            self._settle_multi = make_multi_step(cfg, b, bg, damping=0.995)
            self._renderer = None
            if self._render:
                render = make_renderer(cfg, *self._render_shape)
                zero = torch.zeros((), dtype=torch.int32, device=self.device)
                self._renderer = lambda sim, frame: (render(sim.fluid), zero)

    def _caps(self) -> dict:
        """The capacities recovery can grow (grow_capacities' ``caps``)."""
        if self.domain is None:
            return {"cap": self.engine.spec.cap}
        d = self.domain
        return dict(cap=d.spec.cap, halo_cap=d.halo_cap, mig_cap=d.mig_cap,
                    slab_cap=d.slab_cap)

    def _overflow_line(self, cats, caps: dict, grow: dict, at: float | None) -> str:
        """What the runner says of an overflow, in the JAX runner's words:
        ``at`` is the checkpoint time a revert goes back to, None in the
        settle, which restarts; an empty ``grow`` continues with losses.
        The single engine names its window cap, the slab domain the
        categories it blames and each capacity it grows."""
        then = ("restarting settle" if at is None
                else f"reverting to t={at:.2f}s and replaying")
        if self.domain is None:
            head = "WINDOW OVERFLOW" + (" during settle" if at is None else "")
            if not grow:
                return (f"{head} at cap={caps['cap']} (max-cap reached): "
                        f"continuing with lost pairs")
            return f"{head}: cap {caps['cap']} -> {grow['cap']}, {then}"
        if at is None:
            head, every = "OVERFLOW during settle", "every capacity"
        else:
            head, every = f"OVERFLOW in {sorted(cats)}", "every starved capacity"
        if not grow:
            return f"{head} with {every} at its ceiling: continuing with losses"
        growing = ", ".join(f"{key} -> {val}" for key, val in sorted(grow.items()))
        return f"{head}: growing {growing}, {then}"

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
            sim, st, frame = self._multi(sim, g_trace)
            if self._renderer is None:
                return sim, _reduce(st), None
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

        def start_recovered():
            """start() with settle-overflow recovery: grow the capacities on
            their ladders and redo prime + settle until the pre-roll is
            clean or the ceilings are hit.  Used at run start and on a
            revert-to-start."""
            nonlocal use_ac, recoveries
            sim, settle_ov = start()
            while use_ac and settle_ov > 0:
                # the settle drains only the total: grow every capacity
                caps = self._caps()
                grow = grow_capacities(caps, OVERFLOW_CATEGORIES, self.max_cap,
                                       self.n_fluid)
                say(self._overflow_line(OVERFLOW_CATEGORIES, caps, grow, None))
                if not grow:
                    use_ac = False
                    break
                self._build(grow)
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
                if reporter.total_overflow > 0:
                    # grow exactly the capacities the attribution names; a
                    # loss with no attribution (the single engine, the
                    # render, non-finite rows, lost particles) names none,
                    # so grow them all
                    by = reporter.total_overflow_by
                    cats = (set(OVERFLOW_CATEGORIES) if by is None or int(by.sum()) == 0
                            else {c for c, n in zip(OVERFLOW_CATEGORIES, by) if n > 0})
                    caps = self._caps()
                    grow = grow_capacities(caps, cats, self.max_cap, self.n_fluid)
                    if not grow:
                        use_ac = False
                        say(self._overflow_line(cats, caps, grow, ck_t))
                        continue
                    cause = "dd_growth" if "slab_cap" in caps else "cap_growth"
                    with tracer.span("runner.recover", cause=cause, ticks=lost()):
                        say(self._overflow_line(cats, caps, grow, ck_t))
                        # the slab arrays change shape with the capacities:
                        # a mid-run checkpoint goes through the lossless export
                        ck_export = (self.domain.export(ck_sim)
                                     if self.domain is not None and not ck_is_start
                                     else None)
                        self._build(grow)
                        if ck_is_start:
                            ck_sim = start_recovered()
                        elif ck_export is not None:
                            ck_sim = self.domain.init(*ck_export)
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
                        self._build()
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
                            self._build()
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
