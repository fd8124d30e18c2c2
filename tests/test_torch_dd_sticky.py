"""The port's sticky groups (WindowDomain.make_multi_step(resort_every > 1),
pi_sph_fluid_tpu_torch/parallel/domain_window.py) on the CPU, where each
slab's kernel wrappers run their plain versions: against the port's exact
mode, against JAX's sticky WindowDomain (interpret mode, exact-start
windows, on the 8 virtual CPU devices of tests/conftest.py), the sampled
stats, the drift guard, and the two places where the port departs from
JAX on purpose: the running speed maximum is masked by liveness, and the
group's overflow sum saturates instead of wrapping."""

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
from pi_sph_fluid_tpu_torch.parallel.domain_window import _running_max

torch.set_num_threads(1)

G = (0.0, -9.81)
KW = dict(tq=32, qb=8, cap=256, seg_q=2)
I32_MAX = 2**31 - 1


def _scene(build):
    cfg = J.SPHConfig()
    fluid, braw = build(cfg)
    b, bg = J.prepare_boundary(braw, cfg)
    return dict(cfg=cfg, fluid=fluid, b=b, bg=bg, tcfg=T.SPHConfig(),
                tfluid=convert.fluid_state(fluid, "cpu"),
                tb=convert.boundary_state(b, "cpu"), tbg=convert.grid_context(bg, "cpu"))


@pytest.fixture(scope="module")
def dam():
    """The dam break at the default resolution (400 particles), in both
    packages."""
    return _scene(J.build_dam_break_scene)


def _port(s, d, **kw):
    return WindowDomain(s["tcfg"], s["tb"], s["tbg"], s["fluid"].n,
                        LocalComm(d), "cpu", **dict(KW, **kw))


def _jax(s, d):
    mesh = Mesh(np.asarray(jax.devices()[:d]), ("x",))
    return JWindowDomain(s["cfg"], s["b"], s["bg"], s["fluid"].n, mesh,
                         planes=1, band=0, interpret=True, **KW)


def _g(n):
    return np.tile(np.float32(G), (n, 1))


def _assert_close(got, want, xy=1e-6, uv=1e-5, rho=1e-5):
    for f, tol in (("x", xy), ("y", xy), ("u", uv), ("v", uv)):
        np.testing.assert_allclose(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                   atol=tol, err_msg=f)
    np.testing.assert_allclose(np.asarray(got.rho), np.asarray(want.rho), rtol=rho,
                               atol=1e-2)


def test_sticky_groups_match_exact(dam):
    """test_parallel_window.py:82-99: 4 slabs at resort_every=4 against the
    same domain's exact mode over 12 ticks, within 1e-6 m, 1e-5 m/s and rho
    rtol 1e-5; n_valid whole and no overflow."""
    td = _port(dam, 4)
    state = td.init(dam["tfluid"])
    s1, _ = td.make_multi_step(resort_every=1)(state, _g(12))
    s4, st4 = td.make_multi_step(resort_every=4)(state, _g(12))
    _assert_close(td.gather(s4), td.gather(s1))
    assert int(st4["n_valid"][-1]) == dam["fluid"].n
    assert int(st4["overflow"].max()) == 0


@pytest.fixture(scope="module")
def jax_r4(dam):
    """Two groups of 4 ticks of the 4-slab dam in both packages, from the
    same init."""
    jd = _jax(dam, 4)
    js = jd.init(dam["fluid"])
    ts = convert.domain_state(js, "cpu")
    js, jst = jax.jit(jd.make_multi_step(resort_every=4))(js, jnp.asarray(_g(8)))
    ts, tst = _port(dam, 4).make_multi_step(resort_every=4)(ts, _g(8))
    return ts, tst, js, jst


def test_sticky_groups_match_jax_window_domain(jax_r4):
    """The port's r4 trajectory after two groups against JAX's r4
    WindowDomain: every slot's id equal, the fields within 1e-6 m, 1e-5 m/s
    and rho rtol 1e-5."""
    ts, _, js, _ = jax_r4
    np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
    _assert_close(ts.fluid, js.fluid)


def test_sampled_stats_pattern_equals_jax(jax_r4):
    """The per-tick stats are sampled as JAX samples them
    (`domain_window.py:661-692`): a group's first tick reports its own, the
    carried ticks zeros but ``stale``, the last one the group's maxima,
    overflow and n_valid; the integer stats equal JAX's, the float ones
    within rtol 1e-5."""
    _, tst, _, jst = jax_r4
    assert set(tst) == set(jst)
    for key in ("overflow", "n_valid", "overflow_by", "stale"):
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]), err_msg=key)
    for key in ("max_rho_error_pct", "max_speed"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    n_valid = tst["n_valid"].numpy()
    assert (n_valid[[0, 3, 4, 7]] == 400).all() and (n_valid[[1, 2, 5, 6]] == 0).all()
    assert (tst["max_speed"].numpy()[[1, 2, 5, 6]] == 0).all()
    assert tst["overflow_by"].shape == (8, 4) and tst["stale"].shape == (8,)


def test_dd_sampled_stats_report_group_max(dam):
    """test_parallel_window.py:394-416: a group's first tick reports its own
    stats and its last the group-wide maxima of speed and density error, as
    the exact mode's per-tick stats give them."""
    td = _port(dam, 4)
    state = td.init(dam["tfluid"])
    k, n_groups = 4, 2
    _, st1 = td.make_multi_step(resort_every=1)(state, _g(k * n_groups))
    _, stk = td.make_multi_step(resort_every=k)(state, _g(k * n_groups))
    sp1, rho1 = st1["max_speed"].numpy(), st1["max_rho_error_pct"].numpy()
    spk, rhok = stk["max_speed"].numpy(), stk["max_rho_error_pct"].numpy()
    for i in range(n_groups):
        lo, hi = i * k, (i + 1) * k
        np.testing.assert_allclose(spk[lo], sp1[lo], rtol=1e-5)
        np.testing.assert_allclose(spk[hi - 1], sp1[lo:hi].max(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(rhok[hi - 1], rho1[lo:hi].max(), rtol=1e-3, atol=1e-3)


def test_dd_sticky_guard_trips():
    """test_stale_guard.py:99-112: a 60 m/s particle on the 2-slab drop
    trips the drift guard within a group of 8 (never on its first tick),
    and no particle is lost."""
    drop = _scene(J.build_drop_scene)
    u = drop["tfluid"].u.clone()
    u[0] = 60.0
    td = _port(drop, 2)
    _, st = td.make_multi_step(resort_every=8)(td.init(drop["tfluid"]._replace(u=u)), _g(8))
    stale = st["stale"].numpy()
    assert stale[0] == 0
    assert int(stale.sum()) > 0
    assert int(st["n_valid"][-1]) == drop["fluid"].n


def test_trace_must_be_whole_groups(dam):
    """resort_every must divide the trace length, as the single engine
    requires."""
    td = _port(dam, 2)
    with pytest.raises(ValueError, match="not a multiple of resort_every=4"):
        td.make_multi_step(resort_every=4)(td.init(dam["tfluid"]), _g(6))


def test_running_speed_max_ignores_pad_rows(dam):
    """A pad row of a carried state given a speed: the group's running
    speed maximum leaves it out (masked by liveness), where JAX's unmasked
    fold (`domain_window.py:657`), taken on the same tensors, reports it."""
    td = _port(dam, 2)
    eng, pk, _ = td.layouts(td.init(dam["tfluid"]))[0]
    live = pk[:, 4] > 0
    pad = int(torch.nonzero(~live)[0])
    pk = pk.clone()
    pk[pad, 2] = 50.0
    zero = torch.zeros_like(pk[:, 5])
    rho_hi, sp2_hi = _running_max(zero, zero, pk, live)
    want = float(torch.max(torch.where(live, pk[:, 2] ** 2 + pk[:, 3] ** 2, zero)))
    assert float(sp2_hi.max()) == want < 1.0
    unmasked = jnp.maximum(jnp.asarray(zero.numpy()),
                           jnp.asarray(pk[:, 2].numpy()) ** 2 + jnp.asarray(pk[:, 3].numpy()) ** 2)
    assert float(jnp.max(unmasked)) == 2500.0
    assert float(rho_hi[pad]) == 0.0


def _poison(fluid, rows):
    v = fluid.v.clone()
    v[rows] = float("nan")
    return fluid._replace(v=v)


def test_group_scream_equals_jax_below_the_int32_maximum(dam):
    """8 slabs, one non-finite row in each of three slabs, one group of 2
    ticks: the overflow of both sampled ticks equals JAX's (the scream
    counts every live row, ghosts included, as JAX's does)."""
    x = dam["tfluid"].x.numpy()
    rows = [int(np.argmin(np.abs(x - c))) for c in (0.3, 0.9, 1.3)]
    fl = _poison(dam["tfluid"], rows)
    td, jd = _port(dam, 8), _jax(dam, 8)
    _, t = td.make_multi_step(resort_every=2)(td.init(fl), _g(2))
    jfl = dam["fluid"]._replace(v=jnp.asarray(fl.v.numpy()))
    _, j = jax.jit(jd.make_multi_step(resort_every=2))(jd.init(jfl), jnp.asarray(_g(2)))
    assert int(t["overflow"][0]) >= 3_000_000
    np.testing.assert_array_equal(t["overflow"].numpy(), np.asarray(j["overflow"]))
    np.testing.assert_array_equal(t["overflow_by"].numpy(), np.asarray(j["overflow_by"]))


def test_group_scream_saturates_instead_of_wrapping():
    """A pool of 10,200 particles on 8 slabs with every particle of the
    left three slabs non-finite: each of those slabs screams its most, 1000
    x 1e6, on both sampled ticks of a group, where JAX's int32 ``psum``
    (`domain_window.py:590`) wraps negative.  The port's count saturates at
    the int32 maximum."""
    cfg = T.SPHConfig(r=0.025)
    fluid, braw = T.build_pool_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    dd = WindowDomain(cfg, b, bg, fluid.n, LocalComm(8), "cpu", **KW)
    left = torch.nonzero(fluid.x < 3 * dd.slab_w_cells).reshape(-1)
    assert len(left) > 3000
    _, st = dd.make_multi_step(resort_every=2)(dd.init(_poison(fluid, left)), _g(2))
    assert ((3 * 1000 * 1_000_000 + 2**31) % 2**32) - 2**31 < 0   # an int32 sum
    assert st["overflow"].tolist() == [I32_MAX, I32_MAX]
    assert st["n_valid"].tolist() == [fluid.n, fluid.n]
