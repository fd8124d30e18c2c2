"""Port's WindowEngine vs the JAX WindowEngine, end to end on the CPU.

The port starts from the JAX-primed state (carried across by
pi_sph_fluid_tpu_torch.convert) and steps beside it.  Tolerances are the
JAX package's own engine gates (test_window_engine.py:60-93): the pair
sums run in another order, nothing else differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine as JEngine

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import convert

torch.set_num_threads(1)

G = (0.0, -9.81)
KW = dict(tq=32, qb=8, cap=256, seg_q=2)


def _pair(**kw):
    cfg = J.SPHConfig()
    fluid, braw = J.build_dam_break_scene(cfg)
    b, bg = J.prepare_boundary(braw, cfg)
    je = JEngine(cfg, b, bg, fluid.n, planes=1, band=0, interpret=True, **kw)
    te = T.WindowEngine(T.SPHConfig(), convert.boundary_state(b, "cpu"),
                        convert.grid_context(bg, "cpu"), fluid.n, "cpu", **kw)
    return je, te, fluid


@pytest.fixture(scope="module")
def engines():
    je, te, fluid = _pair(**KW)
    return je, te, fluid, je.prime(fluid, G)


def _by_id(fl):
    return {f: np.asarray(getattr(fl, f)) for f in fl._fields}


def _port_by_id(te, sim):
    return {f: t.numpy() for f, t in zip(T.FluidState._fields, te.unpad(sim))}


def _assert_trajectory(a, b):
    np.testing.assert_allclose(b["x"], a["x"], atol=2e-6)
    np.testing.assert_allclose(b["y"], a["y"], atol=2e-6)
    np.testing.assert_allclose(b["u"], a["u"], atol=2e-4)
    np.testing.assert_allclose(b["v"], a["v"], atol=2e-4)


def test_prime_matches_jax(engines):
    """Priming from the same scene: the layout is bitwise JAX's, rho within
    rtol 1e-6, p within rtol 1e-4 / atol 0.05, accelerations within rtol
    2e-5 / atol 2e-4; pads stay inert."""
    je, te, fluid, jsim = engines
    tsim = te.prime(convert.fluid_state(fluid, "cpu"), G)
    np.testing.assert_array_equal(tsim.ids.numpy(), np.asarray(jsim.ids))
    a, b = _by_id(je.unpad(jsim)), _port_by_id(te, tsim)
    np.testing.assert_array_equal(b["x"], a["x"])
    np.testing.assert_allclose(b["rho"], a["rho"], rtol=1e-6)
    np.testing.assert_allclose(b["p"], a["p"], rtol=1e-4, atol=0.05)
    np.testing.assert_allclose(tsim.au.numpy(), np.asarray(jsim.au), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(tsim.av.numpy(), np.asarray(jsim.av), rtol=2e-5, atol=2e-4)
    pads = tsim.ids.numpy() < 0
    pk = tsim.packed.numpy()
    assert (pk[pads, 4] == 0).all() and (pk[pads, 2] == 0).all()
    assert (tsim.au.numpy()[pads] == 0).all()


def test_trajectory_30_ticks(engines):
    """30 make_step ticks from the JAX-primed state: x, y within 2e-6 m,
    u, v within 2e-4 m/s, overflow 0, ids preserved."""
    je, te, fluid, jsim = engines
    jstep = jax.jit(je.make_step())
    tstep = te.make_step()
    tsim = convert.packed_sim(jsim, "cpu")
    g = jnp.asarray(G, jnp.float32)
    overflow = 0
    for _ in range(30):
        jsim, _ = jstep(jsim, g)
        tsim, st = tstep(tsim, G)
        overflow = max(overflow, int(st.neighbor_overflow))
    assert overflow == 0
    _assert_trajectory(_by_id(je.unpad(jsim)), _port_by_id(te, tsim))
    ids = tsim.ids.numpy()
    assert sorted(ids[ids >= 0]) == list(range(fluid.n))


def test_sticky_groups_match_jax(engines):
    """6 ticks at resort_every=3: the same trajectory gates, stale counts
    equal to JAX's, and the sampled stats equal JAX's (rtol 1e-4)."""
    je, te, fluid, jsim = engines
    gt = np.broadcast_to(np.asarray(G, np.float32), (6, 2))
    js, jst = jax.jit(je.make_multi_step(resort_every=3))(jsim, jnp.asarray(gt))
    ts, tst = te.make_multi_step(resort_every=3)(convert.packed_sim(jsim, "cpu"), gt)
    _assert_trajectory(_by_id(je.unpad(js)), _port_by_id(te, ts))
    np.testing.assert_array_equal(tst.stale.numpy(), np.asarray(jst.stale))
    np.testing.assert_array_equal(tst.neighbor_overflow.numpy(),
                                  np.asarray(jst.neighbor_overflow))
    np.testing.assert_allclose(tst.max_speed.numpy(), np.asarray(jst.max_speed),
                               rtol=1e-4)
    np.testing.assert_allclose(tst.max_rho_error_pct.numpy(),
                               np.asarray(jst.max_rho_error_pct), rtol=1e-3, atol=1e-3)


def test_sampled_stats_report_group_max(engines):
    """The port's own contract (test_window_engine.py:260-281): the fresh
    tick reports its own stats, the group's last tick the group maxima."""
    je, te, fluid, jsim = engines
    sim = convert.packed_sim(jsim, "cpu")
    gt = np.broadcast_to(np.asarray(G, np.float32), (6, 2))
    s1, st1 = te.make_multi_step(resort_every=1)(sim, gt)
    s3, st3 = te.make_multi_step(resort_every=3)(sim, gt)
    f1, f3 = te.unpad(s1), te.unpad(s3)
    np.testing.assert_allclose(f3.x.numpy(), f1.x.numpy(), atol=1e-6)
    np.testing.assert_allclose(f3.u.numpy(), f1.u.numpy(), atol=1e-5)
    sp1, sp3 = st1.max_speed.numpy(), st3.max_speed.numpy()
    assert st1.stale is None and st3.stale.shape == (6,)
    for lo in (0, 3):
        np.testing.assert_allclose(sp3[lo], sp1[lo], rtol=1e-5)
        np.testing.assert_allclose(sp3[lo + 2], sp1[lo:lo + 3].max(), rtol=1e-4)


def test_window_overflow_equals_jax():
    """cap=128 with qb=16 truncates windows: the tick's overflow is > 0 and
    equals the JAX engine's."""
    je, te, fluid = _pair(tq=32, qb=16, cap=128, seg_q=2)
    jsim = je.prime(fluid, G)
    _, jst = jax.jit(je.make_step())(jsim, jnp.asarray(G, jnp.float32))
    _, tst = te.make_step()(convert.packed_sim(jsim, "cpu"), G)
    assert int(tst.neighbor_overflow) > 0
    assert int(tst.neighbor_overflow) == int(jst.neighbor_overflow)


def test_nonfinite_state_screams(engines):
    """A NaN velocity in a real row fires the x1e6 overflow scream."""
    je, te, fluid, jsim = engines
    sim = convert.packed_sim(jsim, "cpu")
    assert int(te.stats(sim).neighbor_overflow) == 0
    row = int(np.nonzero(sim.ids.numpy() == 0)[0][0])
    packed = sim.packed.clone()
    packed[row, 2] = float("nan")
    assert int(te.stats(sim._replace(packed=packed)).neighbor_overflow) >= 1_000_000


def _port_engine(n):
    """A port engine for n fluid particles in the dam scene's box."""
    cfg = T.SPHConfig()
    b, bg = T.prepare_boundary(T.build_dam_break_scene(cfg, "cpu")[1], cfg)
    return T.WindowEngine(cfg, b, bg, n, "cpu", **KW)


def _tiny(cfg, xs, ys, u=0.0, v=0.0):
    n = len(xs)
    one = torch.ones(n)
    return T.FluidState(x=torch.tensor(xs, dtype=torch.float32),
                        y=torch.tensor(ys, dtype=torch.float32),
                        u=u * one, v=v * one, m=cfg.particle_mass * one,
                        rho=cfg.rho_0 * one, p=0 * one)


@pytest.mark.parametrize("xs,ys", [
    ([2.0, 2.01, 2.0], [1.0, 1.0, 1.01]),     # three particles in one cell
    ([0.05], [1.99]),                          # one particle in the corner cell
])
def test_degenerate_scenes(xs, ys):
    """Single-block windows on a mostly empty grid, and the edge-row /
    edge-column window clamps: priming and 3 ticks stay finite, overflow 0,
    ids exact (test_window_engine.py:156-191)."""
    eng = _port_engine(len(xs))
    sim = eng.prime(_tiny(eng.cfg, xs, ys), G)
    sim, st = eng.make_multi_step()(sim, np.tile(np.float32(G), (3, 1)))
    ids = sim.ids.numpy()
    assert sorted(ids[ids >= 0]) == list(range(len(xs)))
    assert int(st.neighbor_overflow.max()) == 0
    rho = eng.unpad(sim).rho.numpy()
    assert np.isfinite(rho).all() and (rho > 0).all()
    assert torch.isfinite(sim.au).all() and torch.isfinite(sim.av).all()


def test_sampled_stats_see_interior_transient():
    """Ballistic particles thrown upward slow down under gravity, so the
    group's largest speed is at its first tick: the sampled last tick must
    report it, not the decayed final speed (test_window_engine.py:284)."""
    xs = [0.8, 1.6, 2.4, 3.2]           # > 2H apart: self-density only, p = 0
    eng = _port_engine(4)
    sim = eng.prime(_tiny(eng.cfg, xs, [1.0] * 4, v=2.0), G)
    gt = np.tile(np.float32(G), (4, 1))
    _, st1 = eng.make_multi_step(resort_every=1)(sim, gt)
    _, st4 = eng.make_multi_step(resort_every=4)(sim, gt)
    sp1 = st1.max_speed.numpy()
    assert sp1[0] > sp1[3] + 1e-3
    np.testing.assert_allclose(st4.max_speed.numpy()[3], sp1.max(), rtol=1e-5)
