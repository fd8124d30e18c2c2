"""The port's WindowDomain (pi_sph_fluid_tpu_torch/parallel/domain_window.py,
exact mode) on the CPU, where each slab's density and forces wrappers run
their plain versions: its integer layout against the JAX package's
WindowDomain bitwise, its trajectory against the port's single engine and
against JAX's WindowDomain (interpret mode, on the 8 virtual CPU devices of
tests/conftest.py), and its capacity accounting.

JAX's side is built with ``planes=1, band=0``, the exact-start fetch the
port ports (ROADMAP Queue 3, "exact-start windows"), so that window
overflow counts compare exactly; ``test_window_overflow_counted_in_dd``
also runs JAX's default dual planes, whose 64-shifted fetch counts at
least as many lanes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.parallel.domain_window import WindowDomain as JWindowDomain

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import convert
from pi_sph_fluid_tpu_torch.parallel import LocalComm, WindowDomain

torch.set_num_threads(1)

G = (0.0, -9.81)
KW = dict(tq=32, qb=8, cap=256, seg_q=2)
I32_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def scene():
    """The dam break at the default resolution (400 particles, 21 x 11
    cells), in both packages."""
    cfg = J.SPHConfig()
    fluid, braw = J.build_dam_break_scene(cfg)
    b, bg = J.prepare_boundary(braw, cfg)
    return dict(cfg=cfg, fluid=fluid, b=b, bg=bg, tcfg=T.SPHConfig(),
                tfluid=convert.fluid_state(fluid, "cpu"),
                tb=convert.boundary_state(b, "cpu"),
                tbg=convert.grid_context(bg, "cpu"))


def _port(s, d, **kw):
    return WindowDomain(s["tcfg"], s["tb"], s["tbg"], s["fluid"].n,
                        LocalComm(d), "cpu", **dict(KW, **kw))


def _jax(s, d, planes=1, **kw):
    mesh = Mesh(np.asarray(jax.devices()[:d]), ("x",))
    return JWindowDomain(s["cfg"], s["b"], s["bg"], s["fluid"].n, mesh,
                         planes=planes, band=0, interpret=True, **dict(KW, **kw))


def _run(dd, state, n, g=G):
    step = dd.make_step()
    stats = []
    for _ in range(n):
        state, st = step(state, g)
        stats.append(st)
    return state, stats


def _run_jax(dd, state, n, g=G):
    step = jax.jit(dd.make_step())
    stats = []
    for _ in range(n):
        state, st = step(state, jnp.asarray(g, jnp.float32))
        stats.append(st)
    return state, stats


@pytest.mark.parametrize("d", [2, 4, 8])
def test_layout_equals_jax(scene, d):
    """k_cols, local_cols, the three capacities, nb_cap, the layout sizes,
    each slab's boundary CSR and boundary rows, and each particle's slab
    after init, bitwise JAX's."""
    td, jd = _port(scene, d), _jax(scene, d)
    for name in ("k_cols", "local_cols", "slab_cap", "halo_cap", "mig_cap"):
        assert getattr(td, name) == getattr(jd, name), name
    assert td.nb_cap == jd.b_geo_sh.shape[0] // d
    assert (td.spec.n_layout, td.spec.L) == (jd.spec.n_layout, jd.spec.L)
    csr = np.asarray(jd.b_csr_sh).reshape(d, -1)
    geo_f = np.asarray(jd.b_geo_sh).reshape(d, td.nb_cap, 8)
    geo_d = np.asarray(jd.b_geo_d_sh).reshape(d, td.nb_cap, 4)
    for s, eng in enumerate(td.engines):
        assert eng.spec == td.spec
        np.testing.assert_array_equal(eng.b_cell_starts.numpy(), csr[s])
        np.testing.assert_array_equal(eng._b_geo_f.numpy(), geo_f[s])
        np.testing.assert_array_equal(eng._b_geo_d.numpy(), geo_d[s])
    js, ts = jd.init(scene["fluid"]), td.init(scene["tfluid"])
    np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
    np.testing.assert_array_equal(ts.fluid.x.numpy(), np.asarray(js.fluid.x))


@pytest.mark.parametrize("d", [4, 8])
def test_slabs_match_single_engine(scene, d):
    """test_parallel_window.py:41-64: 15 steps of d slabs against the
    port's single engine primed and then started from zeroed accelerations,
    as the domain starts."""
    td = _port(scene, d)
    state, stats = _run(td, td.init(scene["tfluid"]), 15)
    eng = T.WindowEngine(scene["tcfg"], scene["tb"], scene["tbg"], scene["fluid"].n,
                         "cpu", **KW)
    sim = eng.prime(scene["tfluid"], G)
    sim = sim._replace(au=torch.zeros_like(sim.au), av=torch.zeros_like(sim.av))
    sim, _ = eng.make_multi_step()(sim, np.tile(np.float32(G), (15, 1)))
    assert int(stats[-1]["n_valid"]) == scene["fluid"].n
    assert max(int(st["overflow"]) for st in stats) == 0
    fd, fe = td.gather(state), eng.unpad(sim)
    np.testing.assert_allclose(fd.x.numpy(), fe.x.numpy(), atol=1e-6)
    np.testing.assert_allclose(fd.y.numpy(), fe.y.numpy(), atol=1e-6)
    np.testing.assert_allclose(fd.u.numpy(), fe.u.numpy(), atol=1e-5)
    np.testing.assert_allclose(fd.rho.numpy(), fe.rho.numpy(), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("d", [4, 8])
def test_slabs_match_jax_window_domain(scene, d):
    """5 steps beside JAX's d-slab WindowDomain from the same init, at the
    engine comparison's tolerances (test_torch_engine.py:51-54: x, y within
    2e-6 m, u, v within 2e-4 m/s); the ids of every slot, n_valid, overflow
    and overflow_by bitwise, the stats within rtol 1e-5."""
    td, jd = _port(scene, d), _jax(scene, d)
    js = jd.init(scene["fluid"])
    ts, tstats = _run(td, convert.domain_state(js, "cpu"), 5)
    js, jstats = _run_jax(jd, js, 5)
    np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
    for f, tol in (("x", 2e-6), ("y", 2e-6), ("u", 2e-4), ("v", 2e-4)):
        np.testing.assert_allclose(getattr(ts.fluid, f).numpy(),
                                   np.asarray(getattr(js.fluid, f)), atol=tol, err_msg=f)
    np.testing.assert_allclose(ts.fluid.rho.numpy(), np.asarray(js.fluid.rho), rtol=1e-6)
    for t, j in zip(tstats, jstats):
        for key in ("n_valid", "overflow", "overflow_by"):
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]), err_msg=key)
        for key in ("max_rho_error_pct", "max_speed"):
            np.testing.assert_allclose(float(t[key]), float(j[key]), rtol=1e-5, atol=1e-6)


def test_multi_step_scan(scene):
    """test_parallel_window.py:67-79: stats stacked per step, overflow_by
    (K, 4) [window, halo, mig, slab], all 0."""
    td = _port(scene, 2)
    state, st = td.make_multi_step()(td.init(scene["tfluid"]),
                                     np.tile(np.float32(G), (5, 1)))
    assert int(st["n_valid"][-1]) == scene["fluid"].n
    assert st["overflow"].shape == (5,) and int(st["overflow"].max()) == 0
    assert st["overflow_by"].shape == (5, 4)
    assert int(st["overflow_by"].max()) == 0
    assert torch.isfinite(state.fluid.x).all()
    assert all(v.dtype in (torch.int32, torch.float32) for v in st.values())


def test_halo_overflow_equals_jax(scene):
    """halo_cap=8 starves the halo exchange: the count is JAX's exactly,
    only the halo column is blamed, and no owned particle is lost."""
    td, jd = _port(scene, 4, halo_cap=8), _jax(scene, 4, halo_cap=8)
    js = jd.init(scene["fluid"])
    _, tstats = _run(td, convert.domain_state(js, "cpu"), 3)
    _, jstats = _run_jax(jd, js, 3)
    for t, j in zip(tstats, jstats):
        assert int(t["n_valid"]) == scene["fluid"].n
        np.testing.assert_array_equal(t["overflow_by"].numpy(), np.asarray(j["overflow_by"]))
        assert int(t["overflow"]) == int(j["overflow"])
    by = np.max([t["overflow_by"].numpy() for t in tstats], axis=0)
    assert by[1] > 0 and by[0] == by[2] == by[3] == 0


def test_window_overflow_counted_in_dd(scene):
    """A window cap below the longest window blames the window column.

    JAX needs a cap of whole 128-lane vectors; at cap=128 every exact-start
    window of this scene fits (the longest is 121 lanes), so the port counts
    0, as JAX's exact-start fetch (planes=1) does, where JAX's default
    dual-plane fetch counts 366 on 2 slabs: it starts at a 64-lane plane
    boundary before the window (the exact-start divergence, ROADMAP Queue 3).
    At cap=96 the port blames the window column alone, with the count of
    lanes past the cap over every slab's windows."""
    ts = _port(scene, 2, cap=128)
    _, (t,) = _run(ts, ts.init(scene["tfluid"]), 1)
    j1 = _jax(scene, 2, cap=128)
    j2 = _jax(scene, 2, planes=2, cap=128)
    (j1,) = _run_jax(j1, j1.init(scene["fluid"]), 1)[1]
    (j2,) = _run_jax(j2, j2.init(scene["fluid"]), 1)[1]
    np.testing.assert_array_equal(t["overflow_by"].numpy(), np.asarray(j1["overflow_by"]))
    assert int(t["overflow"]) == int(j1["overflow"]) == 0
    assert int(np.asarray(j2["overflow_by"])[0]) > 0

    td = _port(scene, 2, cap=96)
    state = td.init(scene["tfluid"])
    want = sum(int(torch.clamp_min(ctx.w_len - 96, 0).sum())
               for _, _, ctx in td.layouts(state))
    _, (t,) = _run(td, state, 1)
    by = t["overflow_by"].numpy()
    assert want > 0 and by[0] == want and by[1] == by[2] == by[3] == 0
    assert int(t["overflow"]) == want


def test_export_init_resumes_exactly(scene):
    """export -> init carries au, av: a resumed step equals the uninterrupted
    one bitwise, in this domain and in one with grown capacities (the
    elastic recovery's rebuild)."""
    td = _port(scene, 4)
    step = td.make_step()
    state, _ = _run(td, td.init(scene["tfluid"]), 3)
    fl, au, av = td.export(state)
    want = td.gather(step(state, G)[0])
    grown = _port(scene, 4, slab_cap=td.slab_cap + 128, halo_cap=td.halo_cap + 64,
                  mig_cap=td.mig_cap + 64, cap=384)
    for dd in (td, grown):
        got = dd.gather(dd.make_step()(dd.init(fl, au, av), G)[0])
        for f in T.FluidState._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          getattr(want, f).numpy(), err_msg=f)


def test_sticky_groups_not_ported_yet(scene):
    """Sticky groups are ported now (tests/test_torch_dd_sticky.py holds
    them against the exact mode and JAX): resort_every=4 builds and runs a
    group on 2 slabs, with the drift guard's ``stale`` beside JAX's stats."""
    td = _port(scene, 2)
    _, st = td.make_multi_step(resort_every=4)(td.init(scene["tfluid"]),
                                               np.tile(np.float32(G), (4, 1)))
    assert set(st) == {"max_rho_error_pct", "max_speed", "overflow", "n_valid",
                       "overflow_by", "stale"}
    assert st["stale"].shape == (4,) and int(st["stale"].sum()) == 0
    assert int(st["n_valid"][-1]) == scene["fluid"].n


def _poison(fluid, rows):
    v = fluid.v.clone()
    v[rows] = float("nan")
    return fluid._replace(v=v)


def test_non_finite_scream_equals_jax_below_the_int32_maximum(scene):
    """8 slabs, one non-finite row in each of three slabs: every count is
    JAX's exactly (the scream, 1e6 a non-finite owned row, is far below the
    int32 maximum, where the saturating sum and JAX's int32 psum agree)."""
    x = scene["tfluid"].x.numpy()
    rows = [int(np.argmin(np.abs(x - c))) for c in (0.3, 0.9, 1.3)]
    td, jd = _port(scene, 8), _jax(scene, 8)
    fl = _poison(scene["tfluid"], rows)
    slabs = {s for s, ids in enumerate(td.init(fl).ids.view(8, -1).tolist())
             if set(rows) & set(ids)}
    assert len(slabs) == 3, slabs
    _, (t,) = _run(td, td.init(fl), 1)
    jfl = scene["fluid"]._replace(v=jnp.asarray(fl.v.numpy()))
    _, (j,) = _run_jax(jd, jd.init(jfl), 1)
    assert int(t["overflow"]) >= 3_000_000
    assert int(t["overflow"]) == int(j["overflow"])
    np.testing.assert_array_equal(t["overflow_by"].numpy(), np.asarray(j["overflow_by"]))


def test_non_finite_scream_saturates_instead_of_wrapping():
    """A pool of 10,200 particles on 8 slabs with every particle of the
    left three slabs non-finite: each of those slabs screams its most, 1000
    x 1e6, so the cross-slab sum passes the int32 maximum, where JAX's int32
    psum (domain_window.py:355, :365) wraps negative.  The port's count
    saturates at the int32 maximum and stays positive."""
    cfg = T.SPHConfig(r=0.025)
    fluid, braw = T.build_pool_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    dd = WindowDomain(cfg, b, bg, fluid.n, LocalComm(8), "cpu", **KW)
    left = torch.nonzero(fluid.x < 3 * dd.slab_w_cells).reshape(-1)
    state, st = dd.make_step()(dd.init(_poison(fluid, left)), G)
    f = state.fluid
    bad = ((f.m > 0) & ~torch.isfinite(f.x + f.u * f.u + f.v * f.v + f.rho))
    per_slab = bad.view(8, -1).sum(1).clamp_max(1000).numpy().astype(np.int64)
    assert (per_slab[:3] == 1000).all()
    true = int(per_slab.sum()) * 1_000_000 + int(st["overflow_by"].sum())
    assert true > I32_MAX
    assert ((true + 2**31) % 2**32) - 2**31 < 0     # what an int32 sum gives
    assert int(st["overflow"]) == I32_MAX
    assert int(st["n_valid"]) == fluid.n
