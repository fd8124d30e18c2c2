"""The port's SimRunner(backend="window-dd") and ``cli run --backend
window-dd`` on the CPU: the runner cases of tests/test_parallel_window.py
(:148-391) and tests/test_recovery_termination.py, run against the port,
and one forced-overflow run whose recovery lines equal the JAX package's
SimRunner(backend="pallas-dd") (interpret mode, exact-start windows, on the
virtual CPU devices of tests/conftest.py)."""

import inspect
import io

import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.io.gravity import ConstantGravity as JConstantGravity
from pi_sph_fluid_tpu.io.host_loop import SimRunner as JSimRunner

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import cli, convert
from pi_sph_fluid_tpu_torch.io.display import FileSink
from pi_sph_fluid_tpu_torch.io.gravity import ConstantGravity
from pi_sph_fluid_tpu_torch.io.host_loop import grow_capacities
from pi_sph_fluid_tpu_torch.models.simulation import OVERFLOW_CATEGORIES, StepStats
from pi_sph_fluid_tpu_torch.parallel import domain_window
from pi_sph_fluid_tpu_torch.render.metaballs import make_renderer
from pi_sph_fluid_tpu_torch.utils.stats import StatsReporter

torch.set_num_threads(1)

CFG = T.SPHConfig()
KW = dict(tq=32, qb=8, cap=256, seg_q=2)
# qb=16 windows overflow cap=128 on the dam with exact-start windows
# (tests/test_torch_runner.py)
OV = dict(tq=32, qb=16, cap=128, seg_q=2)


def _runner(slabs=4, fluid_fn=None, **kw):
    fluid, braw = T.build_dam_break_scene(CFG, "cpu")
    if fluid_fn is not None:
        fluid = fluid_fn(fluid)
    opts = dict(kw.pop("engine_opts", KW), slabs=slabs)
    kw.setdefault("render", False)
    return T.SimRunner(CFG, fluid, braw, backend="window-dd", engine_opts=opts,
                       device="cpu", **kw), fluid


def _caps(runner):
    d = runner.domain
    return dict(cap=d.spec.cap, halo_cap=d.halo_cap, mig_cap=d.mig_cap,
                slab_cap=d.slab_cap)


def test_simrunner_window_dd_backend():
    """test_parallel_window.py:148-168: sticky slab DD through the runner,
    headless, conservation folded into the overflow stat."""
    runner, fluid = _runner(resort_every=4)
    res = runner.run(ConstantGravity(CFG), None, sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=8)
    assert res.steps == 8 and res.dispatches == 1
    assert res.reporter.total_overflow == 0
    assert res.reporter.total_overflow_by.tolist() == [0, 0, 0, 0]
    assert torch.isfinite(res.sim.fluid.x).all()
    assert runner.domain.gather(res.sim).x.shape[0] == fluid.n


def test_simrunner_window_dd_renders(tmp_path):
    """test_parallel_window.py:206-234: one frame a dispatch from the
    per-slab renderer, equal to the oracle renderer on the gathered state."""
    runner, _ = _runner(render=True, resort_every=2)
    path = tmp_path / "dd_frames.bin"
    sink = FileSink(str(path))
    res = runner.run(ConstantGravity(CFG), sink, sim_seconds=4 * CFG.dt,
                     steps_per_dispatch=2)
    sink.close()
    frames = np.fromfile(path, np.uint8).reshape(-1, 1024)
    assert frames.shape[0] == res.dispatches == 2
    assert frames[-1].any()
    ref = make_renderer(CFG)(runner.domain.gather(res.sim)).numpy()
    np.testing.assert_array_equal(frames[-1], ref)


def test_simrunner_dd_autocap_recovery():
    """test_parallel_window.py:275-320: the window cap overflows the dam;
    the attribution names the window alone, so only the cap grows; the
    replayed run ends clean and tracks a run started at the recovered
    cap."""
    log = io.StringIO()
    runner, _ = _runner(engine_opts=OV, resort_every=2, max_cap=512)
    caps0 = _caps(runner)
    res = runner.run(ConstantGravity(CFG), None, sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4, report_stream=log)
    assert res.recoveries >= 1
    assert runner.domain.spec.cap > 128
    assert res.reporter.total_overflow == 0
    assert "OVERFLOW in ['window']" in log.getvalue()
    assert {k: v for k, v in _caps(runner).items() if k != "cap"} == \
        {k: v for k, v in caps0.items() if k != "cap"}
    clean, _ = _runner(engine_opts=dict(OV, cap=runner.domain.spec.cap),
                       resort_every=2, auto_cap=False)
    res2 = clean.run(ConstantGravity(CFG), None, sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4)
    assert res2.reporter.total_overflow == 0
    a, b = runner.domain.gather(res.sim), clean.domain.gather(res2.sim)
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(a.rho.numpy(), b.rho.numpy(), atol=1e-3, rtol=1e-6)


def test_dd_recovery_targets_the_starved_halo():
    """test_parallel_window.py:323-349: a halo_cap of 8 starves the halo
    exchange; recovery names 'halo', grows halo_cap on its ladder and leaves
    the window, migration and slab capacities as they were."""
    log = io.StringIO()
    runner, _ = _runner(engine_opts=dict(KW, halo_cap=8), resort_every=2, max_cap=512)
    caps0 = _caps(runner)
    res = runner.run(ConstantGravity(CFG), None, sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4, report_stream=log)
    assert res.recoveries >= 1
    assert res.reporter.total_overflow == 0
    assert "'halo'" in log.getvalue()
    caps = _caps(runner)
    assert caps["halo_cap"] > 8 and caps["cap"] == 256
    assert (caps["mig_cap"], caps["slab_cap"]) == (caps0["mig_cap"], caps0["slab_cap"])


def test_dd_mid_run_revert_goes_through_export_and_init():
    """A revert whose checkpoint is a resumed state (no re-prime) rebuilds
    the domain with the grown halo and carries the checkpoint across
    through export and init (the slab arrays change shape); the result
    tracks a run started from the same state at the grown capacity."""
    warm, _ = _runner(resort_every=2, auto_cap=False)
    res0 = warm.run(ConstantGravity(CFG), None, sim_seconds=4 * CFG.dt,
                    steps_per_dispatch=4)
    log = io.StringIO()
    runner, _ = _runner(engine_opts=dict(KW, halo_cap=8), resort_every=2)
    # the resumed state must fit the starved domain's slab arrays
    assert runner.domain.slab_cap == warm.domain.slab_cap
    res = runner.run(ConstantGravity(CFG), None, sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4, report_stream=log, resume=res0.sim)
    assert res.recoveries >= 1 and res.reporter.total_overflow == 0
    assert "reverting to t=0.00s" in log.getvalue()
    clean, _ = _runner(engine_opts=dict(KW, halo_cap=runner.domain.halo_cap),
                       resort_every=2, auto_cap=False)
    res2 = clean.run(ConstantGravity(CFG), None, sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4, resume=res0.sim)
    a, b = runner.domain.gather(res.sim), clean.domain.gather(res2.sim)
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), atol=1e-6)
    np.testing.assert_allclose(a.u.numpy(), b.u.numpy(), atol=1e-5)


def test_dd_settle_damps_the_startup_transient():
    """test_parallel_window.py:352-391: (a) a damping of 0.9 applied every
    tick of a sticky multi-step ends far slower than none; (b) the runner's
    damped settle pre-roll runs on window-dd and leaves a finite state."""
    runner, fluid = _runner(slabs=2, resort_every=2)
    dd = runner.domain
    state = dd.init(fluid)
    g30 = np.tile(np.float32([0.0, -9.81]), (30, 1))

    def end_speed(damping):
        st, _ = dd.make_multi_step(resort_every=2, damping=damping)(state, g30)
        f = dd.gather(st)
        return float(torch.hypot(f.u, f.v).max())

    assert end_speed(0.9) < 0.5 * end_speed(1.0)
    res = runner.run(ConstantGravity(CFG), None, sim_seconds=4 * CFG.dt,
                     steps_per_dispatch=4, settle_seconds=8 * CFG.dt)
    f = runner.domain.gather(res.sim)
    assert torch.isfinite(f.x).all() and torch.isfinite(f.u).all()


@pytest.fixture(scope="module")
def ladder_runner():
    return _runner(engine_opts=dict(KW, cap=128), resort_every=2, max_cap=256)[0]


def test_growth_ladders_reach_a_ceiling(ladder_runner):
    """test_recovery_termination.py:39-77: growing every capacity from the
    domain's initial ones reaches the empty proposal in finitely many
    rounds, with halo and migration at the slab bound and never beyond."""
    runner = ladder_runner
    cats = set(OVERFLOW_CATEGORIES)
    caps = runner._caps()
    assert caps == _caps(runner)
    rounds = 0
    while True:
        grow = grow_capacities(caps, cats, runner.max_cap, runner.n_fluid)
        if not grow:
            break
        for k, v in grow.items():
            assert v > caps[k], f"{k} proposal {v} did not grow past {caps[k]}"
        caps.update(grow)
        rounds += 1
        assert rounds < 64, f"growth never terminated: {caps}"
    slab_bound = -(-caps["slab_cap"] // 64) * 64
    assert caps["cap"] <= 256
    assert caps["halo_cap"] <= slab_bound and caps["mig_cap"] <= slab_bound
    assert caps["slab_cap"] <= -(-(runner.n_fluid + 64) // 128) * 128
    assert rounds >= 1


def test_attribution_order_is_single_sourced():
    """test_recovery_termination.py:80-92: both stats paths of the port's
    WindowDomain stack [window, halo, mig, slab] in OVERFLOW_CATEGORIES
    order."""
    src = inspect.getsource(domain_window)
    assert OVERFLOW_CATEGORIES == ("window", "halo", "mig", "slab")
    assert src.count("torch.stack([ov_w.to(_I32), ov_h, ov_mig, ov_cap])") == 2


def test_scream_only_overflow_stops_recovering_at_the_ceilings():
    """test_recovery_termination.py:95-121: a non-finite row screams every
    report with no capacity to blame; the runner grows everything until
    the ladders are spent, says so, and finishes with the scream kept."""
    def poison(fluid):
        u = fluid.u.clone()
        u[0] = float("nan")
        return fluid._replace(u=u)

    log = io.StringIO()
    runner, _ = _runner(fluid_fn=poison, engine_opts=dict(KW, cap=128),
                        resort_every=2, max_cap=256)
    res = runner.run(ConstantGravity(CFG), None, sim_seconds=8 * CFG.dt,
                     steps_per_dispatch=4, report_stream=log)
    assert "continuing with losses" in log.getvalue()
    assert res.recoveries < 64
    assert res.reporter.total_overflow >= 1_000_000
    assert np.isfinite(res.wall_s)


def test_recovery_lines_match_jax():
    """One forced-overflow run in both packages: the dam on 2 slabs with a
    window cap of 128 at qb=16 and a halo_cap of 8; both runners blame the
    same capacities, grow them to the same values, print the same OVERFLOW
    lines and count the same recoveries."""
    jcfg = J.SPHConfig()
    jfluid, braw = J.build_dam_break_scene(jcfg)
    opts = dict(OV, slabs=2, halo_cap=8)
    kw = dict(render=False, resort_every=2, max_cap=512)
    run = dict(sim_seconds=16 * jcfg.dt, steps_per_dispatch=4, report_every=4 * jcfg.dt)
    logs = io.StringIO(), io.StringIO()
    jr = JSimRunner(jcfg, jfluid, braw, backend="pallas-dd",
                    engine_opts=dict(opts, planes=1, band=0, interpret=True), **kw)
    jres = jr.run(JConstantGravity(jcfg), None, report_stream=logs[0], **run)
    tr = T.SimRunner(CFG, convert.fluid_state(jfluid, "cpu"),
                     convert.boundary_state(braw, "cpu"), backend="window-dd",
                     engine_opts=opts, device="cpu", **kw)
    tres = tr.run(ConstantGravity(CFG), None, report_stream=logs[1], **run)
    jlines, tlines = ([ln for ln in log.getvalue().splitlines() if "OVERFLOW in" in ln]
                      for log in logs)
    assert tlines == jlines and len(tlines) >= 2
    assert tres.recoveries == jres.recoveries
    assert _caps(tr) == dict(cap=jr.domain.spec.cap, halo_cap=jr.domain.halo_cap,
                             mig_cap=jr.domain.mig_cap, slab_cap=jr.domain.slab_cap)
    assert tres.reporter.total_overflow == jres.reporter.total_overflow == 0
    np.testing.assert_array_equal(tres.reporter.total_overflow_by,
                                  jres.reporter.total_overflow_by)
    a, b = tr.domain.gather(tres.sim), jr.domain.gather(jres.sim)
    np.testing.assert_allclose(a.x.numpy(), np.asarray(b.x), atol=1e-6)


def test_cli_run_window_dd_writes_a_frame_a_dispatch(tmp_path, capsys):
    """``cli run --backend window-dd --slabs 2 --device cpu --display
    file:`` writes one frame a dispatch, saves the gathered state and
    prints the throughput line; ``cli bench --backend window-dd`` prints
    its JSON line."""
    path, state = tmp_path / "frames.bin", tmp_path / "state.npz"
    k = -(-int(round(1.0 / (60.0 * CFG.dt))) // 8) * 8
    res = cli.main(["run", "--backend", "window-dd", "--slabs", "2", "--device", "cpu",
                    "--scene", "dam", "--seconds", repr(2 * k * CFG.dt),
                    "--display", f"file:{path}", "--save-state", str(state)])
    assert res.dispatches == 2 and res.recoveries == 0
    frames = np.fromfile(path, np.uint8).reshape(-1, 1024)
    assert frames.shape[0] == 2 and frames[-1].any()
    saved = T.load_state(str(state), "cpu")["fluid"]
    assert saved.n == 400 and torch.isfinite(saved.x).all()
    assert "M particle-steps/s" in capsys.readouterr().err
    out = cli.main(["bench", "--backend", "window-dd", "--slabs", "2", "--device", "cpu",
                    "--n", "500", "--steps", "8"])
    assert out["backend"] == "window-dd" and out["steps"] == 8
    assert out["neighbor_overflow"] == 0 and out["stale_drift"] == 0


def test_reporter_carries_overflow_by_through_snapshot_and_restore():
    """StatsReporter.total_overflow_by sums the dispatches' (4,) counts, is
    None where no dispatch reported them, and rewinds with restore."""
    z = torch.zeros(())
    st = StepStats(max_rho_error_pct=z, max_speed=z,
                   neighbor_overflow=torch.tensor(7, dtype=torch.int32),
                   overflow_by=torch.tensor([0, 5, 2, 0], dtype=torch.int32))
    rep = StatsReporter(dt=1e-4, report_every_sim_s=1.0)
    assert rep.total_overflow_by is None
    rep.update(1, st._replace(overflow_by=None))
    assert rep.total_overflow_by is None and rep.total_overflow == 7
    snap = rep.snapshot()
    rep.update(1, st)
    rep.update(1, st)
    assert rep.total_overflow_by.tolist() == [0, 10, 4, 0] and rep.total_overflow == 21
    rep.restore(snap)
    assert rep.total_overflow_by is None and rep.total_overflow == 7
