"""The port's jnp-oracle backend (models/simulation.py, ops/neighbors.py,
ops/density.py, ops/forces.py, ops/sph_operators.py, SimRunner and the CLI
with ``backend="reference"``) on the CPU, against the JAX package on the
same numpy inputs, the float64 brute-force oracle (tests/oracle.py) and the
C reference's 269-particle drop (tests/fixtures/golden_drop.npz).

Ports the oracle parts of test_neighbors.py, test_physics_passes.py,
test_step.py and test_parity.py, at their gates."""

import io
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.io.display import FileSink as JFileSink
from pi_sph_fluid_tpu.io.gravity import ConstantGravity as JConstantGravity
from pi_sph_fluid_tpu.io.host_loop import SimRunner as JSimRunner
from pi_sph_fluid_tpu.ops import density as j_density
from pi_sph_fluid_tpu.ops import forces as j_forces
from pi_sph_fluid_tpu.ops import grid as j_grid
from pi_sph_fluid_tpu.ops import neighbors as j_nb
from pi_sph_fluid_tpu.ops import sph_operators as j_ops

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import cli, convert
from pi_sph_fluid_tpu_torch.core.eos import tait_pressure
from pi_sph_fluid_tpu_torch.io.display import FileSink
from pi_sph_fluid_tpu_torch.io.gravity import ConstantGravity
from pi_sph_fluid_tpu_torch.models import simulation as sim_t
from pi_sph_fluid_tpu_torch.ops import density, forces, sph_operators
from pi_sph_fluid_tpu_torch.ops.grid import build_grid, cell_ids
from pi_sph_fluid_tpu_torch.ops.neighbors import (brute_force_neighbor_mask,
                                                  gather_candidates, pair_mask,
                                                  span_overflow)

from oracle import Oracle

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_drop.npz"
CFG = T.SPHConfig()
JCFG = J.SPHConfig()
G = (0.0, -9.81)
RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def random_points(n, pad=0.0):
    x = RNG.uniform(0.0 - pad, CFG.width + pad, n).astype(np.float32)
    y = RNG.uniform(0.0 - pad, CFG.height + pad, n).astype(np.float32)
    return _t(x), _t(y)


# ---------------------------------------------------------------------------
# neighbours (test_neighbors.py)
# ---------------------------------------------------------------------------


def neighbor_set(qx, qy, tx, ty, exclude_self, cap=256):
    """Accepted (query, original target index) pairs of the grid engine."""
    grid = build_grid(tx, ty, CFG)
    order = grid.order.long()
    cand = gather_candidates(qx, qy, grid, CFG, cap=cap)
    idx = cand.idx.long()
    dx = qx[:, None] - tx[order][idx]
    dy = qy[:, None] - ty[order][idx]
    self_idx = torch.arange(qx.shape[0], dtype=torch.int32) if exclude_self else None
    mask = pair_mask(torch.sqrt(dx * dx + dy * dy), cand.valid, CFG,
                     self_idx=self_idx, cand_idx=cand.idx)
    orig = order[idx]
    return {(i, int(orig[i, k])) for i, k in zip(*np.nonzero(mask.numpy()))}


def brute_pairs(qx, qy, tx, ty, exclude_self):
    """Pairs of the port's brute-force mask, which must equal JAX's."""
    mask = brute_force_neighbor_mask(qx, qy, tx, ty, CFG, exclude_self).numpy()
    jmask = np.asarray(j_nb.brute_force_neighbor_mask(
        jnp.asarray(qx.numpy()), jnp.asarray(qy.numpy()), jnp.asarray(tx.numpy()),
        jnp.asarray(ty.numpy()), JCFG, exclude_self))
    np.testing.assert_array_equal(mask, jmask)
    return {(int(i), int(j)) for i, j in zip(*np.nonzero(mask))}


@pytest.mark.parametrize("n", [10, 100, 700])
def test_same_set_neighbors_match_brute_force(n):
    x, y = random_points(n)
    grid = build_grid(x, y, CFG)
    order = grid.order.long()
    xs, ys = x[order], y[order]
    engine = neighbor_set(xs, ys, x, y, exclude_self=True)
    orig = order.numpy()
    brute = {(i, j) for (i, j) in brute_pairs(xs, ys, x, y, False) if orig[i] != j}
    assert engine == brute


def test_cross_set_and_out_of_domain_neighbors_match_brute_force():
    qx, qy = random_points(200)
    tx, ty = random_points(300)
    assert neighbor_set(qx, qy, tx, ty, False) == brute_pairs(qx, qy, tx, ty, False)
    # out-of-domain queries clamp to the edge cells: a subset of the brute
    # pairs that holds every pair of an in-domain query
    qx, qy = random_points(50, pad=0.5)
    engine, brute = neighbor_set(qx, qy, tx, ty, False), brute_pairs(qx, qy, tx, ty, False)
    inside = ((qx >= 0) & (qx <= CFG.width) & (qy >= 0) & (qy <= CFG.height)).numpy()
    assert engine <= brute
    assert {(i, j) for (i, j) in brute if inside[i]} <= engine


def test_cell_ids_match_reference_formula():
    x = torch.tensor([0.0, 0.2, 3.99])
    y = torch.tensor([0.0, 0.2, 1.99])
    ids = cell_ids(x, y, CFG).numpy()
    cell, m = CFG.cell_length, CFG.n_cell_cols
    assert list(ids) == [int(yy / cell) * m + int(xx / cell)
                         for xx, yy in [(0.0, 0.0), (0.2, 0.2), (3.99, 1.99)]]


@pytest.mark.parametrize("cap", [2, 8, 64, None])
def test_span_overflow_counts_as_jax(cap):
    """Dropped candidates on the drop scene equal JAX's count: 0 at the
    default capacity and at 64, > 0 at 2 and 8."""
    fluid, _ = T.build_drop_scene(CFG, "cpu")
    grid = build_grid(fluid.x, fluid.y, CFG)
    order = grid.order.long()
    got = span_overflow(fluid.x[order], fluid.y[order], grid, CFG, cap=cap)
    jf, _ = J.build_drop_scene(JCFG)
    jgrid = j_grid.build_grid(jf.x, jf.y, JCFG)
    want = j_nb.span_overflow(jf.x[jgrid.order], jf.y[jgrid.order], jgrid, JCFG, cap=cap)
    assert got.dtype == torch.int32 and int(got) == int(want)
    assert (int(got) > 0) == (cap in (2, 8))


# ---------------------------------------------------------------------------
# physics passes (test_physics_passes.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    """The drop in grid order with its candidates, in both packages."""
    fluid, braw = T.build_drop_scene(CFG, "cpu")
    boundary, bgrid = T.prepare_boundary(braw, CFG)
    grid = build_grid(fluid.x, fluid.y, CFG)
    fs = fluid.permute(grid.order)
    jf, jbraw = J.build_drop_scene(JCFG)
    jb, jbgrid = J.prepare_boundary(jbraw, JCFG)
    jgrid = j_grid.build_grid(jf.x, jf.y, JCFG)
    jfs = jf.permute(jgrid.order)
    return dict(
        fs=fs, boundary=boundary, bgrid=bgrid,
        cand_ff=gather_candidates(fs.x, fs.y, grid, CFG),
        cand_fb=gather_candidates(fs.x, fs.y, bgrid, CFG),
        jfs=jfs, jb=jb,
        jcand_ff=j_nb.gather_candidates(jfs.x, jfs.y, jgrid, JCFG),
        jcand_fb=j_nb.gather_candidates(jfs.x, jfs.y, jbgrid, JCFG))


def test_density_pass_matches_jax_and_oracle(scene):
    """Within rtol 1e-6 of JAX's density_pass on the same candidates, and
    within the JAX gate (rtol 2e-5) of the float64 oracle."""
    s = scene
    np.testing.assert_array_equal(s["cand_ff"].idx.numpy(), np.asarray(s["jcand_ff"].idx))
    rho = density.density_pass(s["fs"], s["boundary"], s["cand_ff"], s["cand_fb"], CFG)
    want = j_density.density_pass(s["jfs"], s["jb"], s["jcand_ff"], s["jcand_fb"], JCFG)
    np.testing.assert_allclose(rho.numpy(), np.asarray(want), rtol=1e-6)
    fs, b = s["fs"], s["boundary"]
    o = Oracle(JCFG)
    f64 = lambda t: t.numpy().astype(np.float64)  # noqa: E731
    psi = o.boundary_psi(f64(b.x), f64(b.y), CFG.rho_0)
    rho_o = o.density(f64(fs.x), f64(fs.y), f64(fs.m), f64(b.x), f64(b.y), psi)
    np.testing.assert_allclose(rho.numpy(), rho_o, rtol=2e-5)


def test_accelerations_match_jax_and_oracle(scene):
    """With random velocities (viscosity live): within 1e-5 of JAX's
    acceleration_pass relative to max(|a|, 1) (another float32 rounding of
    the same terms), and within the JAX gate (2e-3) of the float64 oracle."""
    s = scene
    fs, b = s["fs"], s["boundary"]
    rho = density.density_pass(fs, b, s["cand_ff"], s["cand_fb"], CFG)
    rng = np.random.default_rng(1)
    u = rng.normal(0, 1.0, fs.n).astype(np.float32)
    v = rng.normal(0, 1.0, fs.n).astype(np.float32)
    fs = fs._replace(rho=rho, p=tait_pressure(rho, CFG), u=_t(u), v=_t(v))
    au, av = forces.acceleration_pass(fs, b, s["cand_ff"], s["cand_fb"], 0.3, -9.81, CFG)
    jfs = s["jfs"]._replace(rho=jnp.asarray(fs.rho.numpy()), p=jnp.asarray(fs.p.numpy()),
                           u=jnp.asarray(u), v=jnp.asarray(v))
    jau, jav = j_forces.acceleration_pass(jfs, s["jb"], s["jcand_ff"], s["jcand_fb"],
                                          0.3, -9.81, JCFG)
    for got, want in ((au, jau), (av, jav)):
        want = np.asarray(want)
        scale = np.maximum(np.abs(want), 1.0)
        np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0, atol=1e-5)
    f64 = lambda t: t.numpy().astype(np.float64)  # noqa: E731
    au_o, av_o = Oracle(JCFG).accelerations(
        f64(fs.x), f64(fs.y), u.astype(np.float64), v.astype(np.float64), f64(fs.m),
        f64(fs.rho), f64(fs.p), f64(b.x), f64(b.y), f64(b.m), 0.3, -9.81)
    for got, want in ((au, au_o), (av, av_o)):
        scale = np.maximum(np.abs(want), 1.0)
        np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=2e-3)


def test_sph_operators_volume_factor_match_jax(scene):
    """The never-used VOLUME leading factor (`test_io.py:405-433`): the
    interpolated constant 1 is ~1 (partition of unity) and its gradient ~0
    in the interior; both equal JAX's within 1e-6 relative, and the MASS
    form reproduces density_pass less the self term."""
    s = scene
    fs, cand = s["fs"], s["cand_ff"]
    rho = density.density_pass(fs, s["boundary"], cand, s["cand_fb"], CFG)
    ones = torch.ones_like(fs.x)
    interp = sph_operators.sph_interpolate(ones, fs.x, fs.y, fs.x, fs.y, fs.m, rho,
                                           cand, CFG, leading_factor="volume",
                                           exclude_self=True)
    gx, gy = sph_operators.sph_gradient(ones, fs.x, fs.y, fs.x, fs.y, fs.m, rho, cand,
                                        CFG, leading_factor="volume", exclude_self=True)
    assert 0.5 < float(interp.median()) < 1.05
    assert float(gx.abs().median()) < 5.0
    jfs = s["jfs"]
    jrho = jnp.asarray(rho.numpy())
    jones = jnp.ones_like(jfs.x)
    want = j_ops.sph_interpolate(jones, jfs.x, jfs.y, jfs.x, jfs.y, jfs.m, jrho,
                                 s["jcand_ff"], JCFG, leading_factor="volume",
                                 exclude_self=True)
    np.testing.assert_allclose(interp.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    jgx, jgy = j_ops.sph_gradient(jones, jfs.x, jfs.y, jfs.x, jfs.y, jfs.m, jrho,
                                  s["jcand_ff"], JCFG, leading_factor="volume",
                                  exclude_self=True)
    for got, w in ((gx, jgx), (gy, jgy)):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    mass = sph_operators.sph_interpolate(ones, fs.x, fs.y, fs.x, fs.y, fs.m, rho,
                                         cand, CFG, exclude_self=True)
    ff = density.weighted_kernel_sum(fs.x, fs.y, fs.x, fs.y, fs.m, cand, CFG, True)
    np.testing.assert_array_equal(mass.numpy(), ff.numpy())
    with pytest.raises(ValueError):
        sph_operators.sph_interpolate(ones, fs.x, fs.y, fs.x, fs.y, fs.m, rho, cand,
                                      CFG, leading_factor="area")


# ---------------------------------------------------------------------------
# the stepper (test_step.py) and the C golden (test_parity.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drop():
    fluid, braw = T.build_drop_scene(CFG, "cpu")
    boundary, bgrid = T.prepare_boundary(braw, CFG)
    return sim_t.prime(fluid, boundary, bgrid, G, CFG), boundary, bgrid


@pytest.fixture(scope="module")
def trajectory(drop):
    """States by id at steps 0, 100, 200 and 500, with the stats."""
    sim, boundary, bgrid = drop
    multi = sim_t.make_multi_step(CFG, boundary, bgrid)
    out, sts, step = {0: sim}, [], 0
    for stop in (100, 200, 500):
        sim, st = multi(sim, np.tile(np.float32(G), (stop - step, 1)))
        sts.append(st)
        step = stop
        out[step] = sim
    return out, sim_t.StepStats(*(torch.cat(v) for v in zip(*[s[:3] for s in sts])))


def _by_id(sim):
    inv = torch.argsort(sim.ids.long())
    return {f: getattr(sim.fluid, f)[inv].numpy() for f in T.FluidState._fields}


def test_prime_matches_jax(drop):
    """Sort order (ids) exact, density within rtol 1e-6 and accelerations
    within 1e-5 of max(|a|, 1) of JAX's prime."""
    sim, _, _ = drop
    jf, jbraw = J.build_drop_scene(JCFG)
    jb, jbg = J.prepare_boundary(jbraw, JCFG)
    jsim = J.prime(jf, jb, jbg, G, JCFG)
    np.testing.assert_array_equal(sim.ids.numpy(), np.asarray(jsim.ids))
    np.testing.assert_allclose(sim.fluid.rho.numpy(), np.asarray(jsim.fluid.rho), rtol=1e-6)
    for got, want in ((sim.au, jsim.au), (sim.av, jsim.av)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy() / np.maximum(np.abs(want), 1.0),
                                   want / np.maximum(np.abs(want), 1.0), atol=1e-5)


def test_golden_primed_density_and_pressure(trajectory):
    gs = np.load(FIXTURE)["states"][0]
    ours = _by_id(trajectory[0][0])
    np.testing.assert_allclose(ours["rho"], gs[:, 5], rtol=3e-6)
    np.testing.assert_allclose(ours["p"], gs[:, 6], rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("step,pos_tol,vel_tol", [
    (100, 5e-6, 5e-5),
    (200, 1e-5, 1e-4),
    (500, 1e-4, 5e-3),
])
def test_golden_trajectory_parity(trajectory, step, pos_tol, vel_tol):
    """The C golden drop at test_parity.py's gates."""
    golden = np.load(FIXTURE)
    dump = step // 10
    assert int(golden["steps"][dump]) == step
    gs, ours = golden["states"][dump], _by_id(trajectory[0][step])
    np.testing.assert_allclose(ours["x"], gs[:, 0], atol=pos_tol)
    np.testing.assert_allclose(ours["y"], gs[:, 1], atol=pos_tol)
    np.testing.assert_allclose(ours["u"], gs[:, 2], atol=vel_tol)
    np.testing.assert_allclose(ours["v"], gs[:, 3], atol=vel_tol)
    if step == 500:
        np.testing.assert_allclose(ours["rho"], gs[:, 5], rtol=1e-4)


def test_drop_runs_stably(trajectory):
    """The invariants the reference prints, over the 500 ticks: density
    error and speed bounded (C/10 = 40 m/s), no overflow, the fluid in the
    box and fallen to the lower half (`test_step.py:37-54`)."""
    states, st = trajectory
    assert st.max_speed.shape == (500,)
    assert float(st.max_speed.max()) < 40.0
    assert float(st.max_rho_error_pct.max()) < 10.0
    assert int(st.neighbor_overflow.sum()) == 0
    f = states[500].fluid
    assert bool(torch.isfinite(f.x).all())
    assert float(f.x.min()) > -0.1 and float(f.x.max()) < CFG.width + 0.1
    assert float(f.y.min()) > -0.1 and float(f.y.max()) < CFG.height + 0.1
    assert float(f.y.min()) < 0.35
    assert sorted(states[500].ids.tolist()) == list(range(f.n))


def test_multi_step_equals_repeated_single_steps(drop):
    sim, boundary, bgrid = drop
    step = sim_t.make_step(CFG, boundary, bgrid)
    s1 = sim
    for _ in range(5):
        s1, st = step(s1, G)
    s2, sts = sim_t.make_multi_step(CFG, boundary, bgrid)(sim, np.tile(np.float32(G), (5, 1)))
    for a, b in zip(s1, s2):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert sts.max_speed.shape == (5,) and int(st.neighbor_overflow) == 0


def test_gravity_trace_drives_motion(drop):
    sim, boundary, bgrid = drop
    out, _ = sim_t.make_multi_step(CFG, boundary, bgrid)(
        sim, np.tile(np.float32([9.81, 0.0]), (50, 1)))
    assert float(out.fluid.u.mean()) > 0.05


def test_nonfinite_state_screams_in_stats(drop):
    sim, _, _ = drop
    assert int(sim_t.stats(sim, CFG).neighbor_overflow) == 0
    u = sim.fluid.u.clone()
    u[3] = float("nan")
    bad = sim._replace(fluid=sim.fluid._replace(u=u))
    assert int(sim_t.stats(bad, CFG).neighbor_overflow) >= 1_000_000


# ---------------------------------------------------------------------------
# SimRunner(backend="reference") and the CLI
# ---------------------------------------------------------------------------


def test_runner_reference_frames_and_state_match_jax(tmp_path):
    """Two dispatches of 4 ticks with a frame each through both packages'
    SimRunner(backend="reference") and the oracle renderers: frames agree
    >= 99.5%, the final state by id within the engine gates (x, y 2e-6 m;
    u, v 2e-4 m/s); no recovery, no ladder (resort_every is ignored)."""
    jfluid, jbraw = J.build_drop_scene(JCFG)
    kw = dict(backend="reference", render=True, resort_every=8, max_resort=64)
    jr = JSimRunner(JCFG, jfluid, jbraw, **kw)
    tr = T.SimRunner(CFG, convert.fluid_state(jfluid, "cpu"),
                     convert.boundary_state(jbraw, "cpu"), device="cpu", **kw)
    assert tr.engine is None and not tr.auto_cap
    paths = (tmp_path / "jax.bin", tmp_path / "port.bin")
    jsink, tsink = JFileSink(str(paths[0])), FileSink(str(paths[1]))
    logs = io.StringIO(), io.StringIO()
    jres = jr.run(JConstantGravity(JCFG), jsink, sim_seconds=8 * JCFG.dt,
                  steps_per_dispatch=4, report_stream=logs[0])
    tres = tr.run(ConstantGravity(CFG), tsink, sim_seconds=8 * CFG.dt,
                  steps_per_dispatch=4, report_stream=logs[1])
    jsink.close()
    tsink.close()
    jframes, tframes = (np.fromfile(p, np.uint8).reshape(-1, 1024) for p in paths)
    assert jframes.shape == tframes.shape == (2, 1024)
    for a, b in zip(jframes, tframes):
        assert (T.unpack_framebuffer(a) == T.unpack_framebuffer(b)).mean() >= 0.995
    assert tres.steps == jres.steps == 8 and tres.dispatches == 2
    assert tres.recoveries == jres.recoveries == 0
    inv = np.argsort(np.asarray(jres.sim.ids))
    ours = _by_id(tres.sim)
    for f, atol in (("x", 2e-6), ("y", 2e-6), ("u", 2e-4), ("v", 2e-4)):
        np.testing.assert_allclose(ours[f], np.asarray(getattr(jres.sim.fluid, f))[inv],
                                   atol=atol, err_msg=f)
    assert tres.reporter.total_overflow == jres.reporter.total_overflow == 0
    assert "RESORT LADDER" not in logs[1].getvalue()


def test_cli_backend_reference(tmp_path, capsys):
    """`run --backend reference` writes frames and a checkpoint of the
    grid-ordered fluid with its ids and accelerations (the JAX CLI's
    reference format), and `bench --backend reference` names its backend;
    the DD backend builds beside it, with a domain and no engine
    (tests/test_torch_dd_runner.py runs it)."""
    path, ck = tmp_path / "f.bin", tmp_path / "s.npz"
    dt = CFG.dt
    res = cli.main(["run", "--backend", "reference", "--device", "cpu", "--scene",
                    "drop", "--display", f"file:{path}", "--seconds", repr(8 * dt),
                    "--steps-per-dispatch", "4", "--save-state", str(ck)])
    assert res.steps == 8 and res.recoveries == 0 and res.reporter.total_overflow == 0
    size = path.stat().st_size
    assert size == 2 * 1024, size   # one frame a dispatch
    saved = np.load(ck)
    assert {"fluid.x", "ids", "au", "av"} <= set(saved.files)
    assert sorted(saved["ids"]) == list(range(269))
    capsys.readouterr()
    out = cli.main(["bench", "--backend", "reference", "--device", "cpu", "--n", "500",
                    "--steps", "4"])
    assert out["backend"] == "reference" and out["neighbor_overflow"] == 0
    dd = T.SimRunner(CFG, *T.build_drop_scene(CFG, "cpu"), backend="window-dd",
                     device="cpu", render=False)
    assert dd.engine is None and dd.domain.n_slabs == 1
