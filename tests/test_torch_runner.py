"""The port's SimRunner on the CPU: the runner cases of tests/test_io.py
(:488-720) and tests/test_stale_guard.py (:115-175), run against the
window backend (the JAX package's "pallas") with device="cpu".  The port's
plain kernel versions run here; the recovery, ladder and frame contracts
are the JAX runner's."""

import io

import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch.io.display import FileSink, PngSink
from pi_sph_fluid_tpu_torch.io.gravity import ConstantGravity, RotatingGravity
from pi_sph_fluid_tpu_torch.io.host_loop import grow_capacities
from pi_sph_fluid_tpu_torch.models.simulation import OVERFLOW_CATEGORIES
from pi_sph_fluid_tpu_torch.utils.tracer import tracer

torch.set_num_threads(1)

CFG = T.SPHConfig()
KW = dict(tq=32, qb=8, cap=256, seg_q=2)
# qb=16 windows overflow cap=128 on the drop and the dam with exact-start
# windows (the JAX cases overflow at qb=8 through their dual-plane fetch)
OV = dict(tq=32, qb=16, cap=128, seg_q=2)


def _runner(scene="drop", fluid_fn=None, **kw):
    fluid, braw = {"drop": T.build_drop_scene,
                   "dam": T.build_dam_break_scene}[scene](CFG, "cpu")
    if fluid_fn is not None:
        fluid = fluid_fn(fluid)
    kw.setdefault("engine_opts", dict(KW))
    return T.SimRunner(CFG, fluid, braw, backend="window", device="cpu", **kw), fluid


def _fast(speed):
    """One particle at ``speed`` m/s in +x: a synthetic source of staleness
    (test_stale_guard.py:44-50)."""
    def fn(fluid):
        u = fluid.u.clone()
        u[0] = speed
        return fluid._replace(u=u)
    return fn


def test_other_backends_not_ported():
    """Every backend of the JAX runner is ported under the port's names:
    slab domain decomposition ("window-dd", tests/test_torch_dd_runner.py)
    builds on the CPU with its domain and no engine, the jnp oracle
    (tests/test_torch_oracle.py) without either; a JAX name or an unknown
    one raises."""
    fluid, braw = T.build_drop_scene(CFG, "cpu")
    dd = T.SimRunner(CFG, fluid, braw, backend="window-dd", device="cpu",
                     engine_opts=dict(KW, slabs=2))
    assert dd.engine is None and dd.domain.n_slabs == 2
    ref = T.SimRunner(CFG, fluid, braw, backend="reference", device="cpu")
    assert ref.engine is None and ref.domain is None
    for name in ("pallas", "pallas-dd", "no-such-backend"):
        with pytest.raises(ValueError, match="unknown backend"):
            T.SimRunner(CFG, fluid, braw, backend=name, device="cpu")


def test_render_dispatch_writes_one_frame_per_dispatch(tmp_path):
    """Sticky multi-step + frame-reuse render + overflow folding + the frame
    pushed one dispatch late (test_io.py:488): 2 dispatches, 2 frames."""
    runner, _ = _runner(resort_every=2)
    path = tmp_path / "frames.bin"
    sink = FileSink(str(path))
    res = runner.run(ConstantGravity(CFG), sink, sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4)
    sink.close()
    assert res.steps == 8 and res.dispatches == 2
    assert res.reporter.total_overflow == 0
    frames = np.fromfile(path, np.uint8)
    assert frames.size == 2 * 1024
    assert frames.any()
    # the CPU runs the plain version
    assert tracer.counters.get("kernel.field.launches", 0) == 0


def test_autocap_recovery_replays_clean():
    """cap=128 overflows the dam: the runner grows the cap, reverts and
    replays with the rotating source's logged traces; the result equals a
    run started at the recovered cap, bitwise (test_io.py:515)."""
    log = io.StringIO()
    runner, _ = _runner("dam", engine_opts=dict(OV), render=False,
                        max_cap=512)
    res = runner.run(RotatingGravity(CFG, period_s=0.05), sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4, report_stream=log)
    assert res.recoveries >= 1
    assert runner.engine.spec.cap > 128
    assert res.reporter.total_overflow == 0
    assert "WINDOW OVERFLOW" in log.getvalue()
    clean, _ = _runner("dam", engine_opts=dict(OV, cap=runner.engine.spec.cap),
                       render=False, auto_cap=False)
    res2 = clean.run(RotatingGravity(CFG, period_s=0.05), sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4)
    a, b = runner.engine.unpad(res.sim), clean.engine.unpad(res2.sim)
    assert torch.equal(a.x, b.x) and torch.equal(a.rho, b.rho)


def test_autocap_ceiling_keeps_counting():
    """At max_cap the runner stops recovering and the overflow stays
    visible (test_io.py:556)."""
    log = io.StringIO()
    runner, _ = _runner("dam", engine_opts=dict(OV), render=False,
                        max_cap=128)
    res = runner.run(ConstantGravity(CFG), sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4, report_stream=log)
    assert res.recoveries == 0
    assert res.reporter.total_overflow > 0
    assert "max-cap reached" in log.getvalue()


def test_autocap_settle_recovery():
    """Overflow in the damped pre-roll restarts the settle under a grown cap
    (test_io.py:576)."""
    log = io.StringIO()
    runner, _ = _runner("dam", engine_opts=dict(OV), render=False,
                        max_cap=512)
    res = runner.run(ConstantGravity(CFG), sim_seconds=4 * CFG.dt,
                     steps_per_dispatch=4, settle_seconds=4 * CFG.dt,
                     report_stream=log)
    assert res.recoveries >= 1
    assert "during settle" in log.getvalue()
    assert res.reporter.total_overflow == 0


def test_autocap_recovery_with_renderer(tmp_path):
    """Frames pushed before a revert stay, the pending one is dropped, the
    replay pushes corrected ones: the last frame equals a clean run's
    (test_io.py:598)."""
    runner, _ = _runner(engine_opts=dict(OV), max_cap=512)
    p1, p2 = tmp_path / "recovered.bin", tmp_path / "clean.bin"
    sink = FileSink(str(p1))
    res = runner.run(ConstantGravity(CFG), sink, sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4)
    sink.close()
    assert res.recoveries >= 1 and res.reporter.total_overflow == 0
    clean, _ = _runner(engine_opts=dict(OV, cap=runner.engine.spec.cap),
                       auto_cap=False)
    sink2 = FileSink(str(p2))
    clean.run(ConstantGravity(CFG), sink2, sim_seconds=8 * CFG.dt,
              steps_per_dispatch=4)
    sink2.close()
    rec = np.fromfile(p1, np.uint8).reshape(-1, 1024)
    ref = np.fromfile(p2, np.uint8).reshape(-1, 1024)
    # one render per dispatch, replays included; each revert drops its one
    # pending frame
    assert res.dispatches > ref.shape[0] == 2
    assert rec.shape[0] == res.dispatches - res.recoveries
    assert (rec[-1] == ref[-1]).all()


def test_autocap_recovery_with_resume():
    """A revert whose checkpoint is a resumed state replays from it, never
    re-primes (test_io.py:636)."""
    warm, _ = _runner("dam", engine_opts=dict(OV, cap=256), render=False,
                      auto_cap=False)
    res0 = warm.run(ConstantGravity(CFG), sim_seconds=4 * CFG.dt,
                    steps_per_dispatch=4)
    runner, _ = _runner("dam", engine_opts=dict(OV), render=False,
                        max_cap=512)
    res = runner.run(ConstantGravity(CFG), sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4, resume=res0.sim)
    assert res.recoveries >= 1 and res.reporter.total_overflow == 0
    clean, _ = _runner("dam", engine_opts=dict(OV, cap=runner.engine.spec.cap),
                       render=False, auto_cap=False)
    res2 = clean.run(ConstantGravity(CFG), sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4, resume=res0.sim)
    assert torch.equal(runner.engine.unpad(res.sim).x, clean.engine.unpad(res2.sim).x)


def test_next_cap_ladder():
    """The single engine's one capacity on the one ladder: 1.5x rounded up
    to the 128-lane quantum, bounded by max_cap, then no proposal."""
    runner, _ = _runner(engine_opts=dict(OV), render=False, max_cap=1024)
    assert runner._caps() == {"cap": 128}
    window = {"window"}
    assert [grow_capacities({"cap": c}, window, runner.max_cap, runner.n_fluid)["cap"]
            for c in (128, 256, 384, 512, 896)] == [256, 384, 640, 768, 1024]
    assert grow_capacities({"cap": 1024}, window, runner.max_cap, runner.n_fluid) == {}


@pytest.mark.parametrize("cats", [{"window"}, {"halo"}, {"mig", "slab"},
                                  set(OVERFLOW_CATEGORIES)],
                         ids=["window", "halo", "mig_slab", "all"])
def test_single_engine_grows_only_its_cap(cats):
    """Whatever categories are starved, the single engine's capacities
    ({"cap"} alone) grow only ``cap``: by one rung when the window is
    starved, not at all otherwise, and never past max_cap."""
    for cap in (128, 896, 1024):
        grow = grow_capacities({"cap": cap}, cats, 1024, 269)
        assert set(grow) <= {"cap"}
        want = min(-(-(cap * 3 // 2) // 128) * 128, 1024)
        assert grow == ({"cap": want} if "window" in cats and want > cap else {})


def test_render_shape_plumbs_to_renderer_and_sinks(tmp_path):
    """A 32x64 raster end to end: 256-byte frames, a visible blob, PNG
    geometry (test_io.py:690)."""
    runner, _ = _runner(render_shape=(32, 64))
    p = tmp_path / "frames.bin"
    sink = FileSink(str(p))
    runner.run(ConstantGravity(CFG), sink, sim_seconds=6 * CFG.dt,
               steps_per_dispatch=3)
    sink.close()
    raw = p.read_bytes()
    assert len(raw) > 0 and len(raw) % 256 == 0
    img = T.unpack_framebuffer(np.frombuffer(raw[-256:], np.uint8), 32, 64)
    assert img.any() and not img.all()
    png = PngSink(str(tmp_path / "f"), 32, 64, scale=2)
    png.push(np.frombuffer(raw[-256:], np.uint8))
    data = (tmp_path / "f_000000.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert data[16:24] == (128).to_bytes(4, "big") + (64).to_bytes(4, "big")


def test_runner_raises_resort_when_clean():
    """A quiet flow climbs the upward ladder 2 -> 4 -> 8, capped at
    max_resort, with stale 0 (test_stale_guard.py:115)."""
    stream = io.StringIO()
    runner, _ = _runner(render=False, resort_every=2, max_resort=8, raise_after=1)
    result = runner.run(ConstantGravity(CFG), sim_seconds=0.032,
                        steps_per_dispatch=16, report_stream=stream,
                        report_every=0.004)
    assert "RESORT LADDER" in stream.getvalue()
    assert runner._resort == 8
    assert result.reporter.total_stale == 0
    assert result.recoveries == 0


def test_ladder_ceiling_pinned_below_tripped_period():
    """60 m/s trips 8 and 4; 2 is quiet, and the ceiling stays at 2
    (test_stale_guard.py:137)."""
    stream = io.StringIO()
    runner, _ = _runner(fluid_fn=_fast(60.0), render=False, resort_every=8,
                        max_resort=16, raise_after=1)
    result = runner.run(ConstantGravity(CFG), sim_seconds=0.04,
                        steps_per_dispatch=16, report_stream=stream,
                        report_every=0.004)
    assert "STALE DRIFT" in stream.getvalue()
    assert runner._resort == 2 and runner._resort_ceiling == 2
    assert result.reporter.total_stale == 0


def test_runner_downgrades_resort_on_stale():
    """The downgrade ladder lands on the largest period the flow allows
    (test_stale_guard.py:159)."""
    stream = io.StringIO()
    runner, _ = _runner(fluid_fn=_fast(60.0), render=False, resort_every=8)
    result = runner.run(ConstantGravity(CFG), sim_seconds=0.02,
                        report_stream=stream, report_every=0.005)
    assert "STALE DRIFT" in stream.getvalue()
    assert runner._resort == 2
    assert result.recoveries >= 2
    assert result.reporter.total_stale == 0


def test_realtime_pacing_keeps_sim_time():
    """--realtime paces each dispatch to its sim-time deadline: a run of
    sim time s takes at least s of wall time."""
    runner, _ = _runner(render=False)
    res = runner.run(ConstantGravity(CFG), sim_seconds=16 * CFG.dt,
                     steps_per_dispatch=8, realtime=True)
    assert res.steps == 16
    assert res.wall_s >= 16 * CFG.dt


@pytest.fixture
def spans_on():
    """The process's tracer, on and empty for the test, off and empty after."""
    tracer.clear()
    tracer.enable()
    yield tracer
    tracer.disable()
    tracer.clear()


def _counted(runner):
    """Wrap the runner's dispatch to count the ticks it runs."""
    ticks = []
    dispatch = runner._dispatch

    def counted(sim, g_trace):
        ticks.append(len(g_trace))
        return dispatch(sim, g_trace)

    runner._dispatch = counted
    return ticks


def test_reverts_count_the_ticks_they_throw_away(spans_on):
    """A dam at r8 with one particle at 60 m/s trips the stale guard: each
    revert adds the ticks run since its checkpoint to runner.ticks_reverted
    and gives them as the ticks of its runner.recover span, and together
    they are the ticks run less the ticks committed."""
    stream = io.StringIO()
    runner, _ = _runner("dam", fluid_fn=_fast(60.0), render=False,
                        resort_every=8, max_resort=8)
    ticks = _counted(runner)
    res = runner.run(ConstantGravity(CFG), sim_seconds=0.02, steps_per_dispatch=16,
                     report_stream=stream, report_every=0.005)
    assert "STALE DRIFT" in stream.getvalue() and res.recoveries >= 1
    recovers = [s for s in spans_on.spans if s.name == "runner.recover"]
    assert len(recovers) == res.recoveries
    assert {s.attrs["cause"] for s in recovers} == {"stale"}
    assert all(s.attrs["ticks"] > 0 and s.attrs["ticks"] % 16 == 0 for s in recovers)
    lost = sum(ticks) - res.steps
    assert lost > 0
    assert spans_on.counters["runner.ticks_reverted"] == lost
    assert sum(s.attrs["ticks"] for s in recovers) == lost


def test_a_clean_run_reverts_no_ticks(spans_on):
    """Without a fast particle the same dam runs clean: the counter reads 0
    and no runner.recover span opens."""
    runner, _ = _runner("dam", render=False, resort_every=8, max_resort=8)
    ticks = _counted(runner)
    res = runner.run(ConstantGravity(CFG), sim_seconds=0.02, steps_per_dispatch=16,
                     report_every=0.005)
    assert res.recoveries == 0 and sum(ticks) == res.steps
    assert spans_on.counters["runner.ticks_reverted"] == 0
    assert not [s for s in spans_on.spans if s.name == "runner.recover"]


@pytest.mark.parametrize("backend,opts,cause", [
    ("window", dict(OV), "cap_growth"),
    ("window-dd", dict(OV, slabs=2), "dd_growth"),
], ids=["engine", "domain"])
def test_growth_reverts_name_their_backend(spans_on, backend, opts, cause):
    """A forced window overflow on the dam: each growth revert of the one
    recovery path opens a runner.recover span, named cap_growth on the
    single engine and dd_growth on the slab domain, with the ticks it threw
    away, and the run ends clean."""
    fluid, braw = T.build_dam_break_scene(CFG, "cpu")
    runner = T.SimRunner(CFG, fluid, braw, backend=backend, engine_opts=opts,
                         render=False, max_cap=512, device="cpu")
    res = runner.run(ConstantGravity(CFG), sim_seconds=8 * CFG.dt, steps_per_dispatch=4)
    recovers = [s for s in spans_on.spans if s.name == "runner.recover"]
    assert res.recoveries >= 1 and len(recovers) == res.recoveries
    assert {s.attrs["cause"] for s in recovers} == {cause}
    assert all(s.attrs["ticks"] > 0 for s in recovers)
    assert spans_on.counters["runner.ticks_reverted"] == sum(s.attrs["ticks"] for s in recovers)
    assert res.reporter.total_overflow == 0
