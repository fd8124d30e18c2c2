"""Port vs the JAX package: the row-triple relayout (integer arrays, exact)
and the two window passes (the port's plain versions vs the Pallas kernels
in interpret mode, on the same numpy-made inputs).

The JAX side is WindowEngine(..., planes=1, band=0, interpret=True): the
exact-start layout the port implements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine as JEngine
from pi_sph_fluid_tpu.ops.pallas.window_kernels import (density_window_call,
                                                         forces_window_call)

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import convert
from pi_sph_fluid_tpu_torch.ops.window import window_kernels as wk

torch.set_num_threads(1)

G = (0.0, -9.81)
SMALL = dict(tq=32, qb=8, cap=256, seg_q=2)


def _engines(cfg_kw, scene, fluid_fn=None, **kw):
    jc, tc = J.SPHConfig(**cfg_kw), T.SPHConfig(**cfg_kw)
    build = {"drop": J.build_drop_scene, "dam": J.build_dam_break_scene,
             "pool": J.build_pool_scene}[scene]
    fluid, braw = build(jc)
    if fluid_fn is not None:
        fluid = fluid_fn(jc, fluid)
    b, bg = J.prepare_boundary(braw, jc)
    je = JEngine(jc, b, bg, fluid.n, planes=1, band=0, interpret=True, **kw)
    te = T.WindowEngine(tc, convert.boundary_state(b, "cpu"),
                        convert.grid_context(bg, "cpu"), fluid.n, "cpu", **kw)
    return je, te, fluid


@pytest.mark.parametrize("case", ["dam_small", "drop_small", "pool_default",
                                  "dam_cap128"])
def test_relayout_integer_arrays_equal(case):
    """layout_src, trip_src, w_start, w_len, flen, T and overflow equal the
    JAX relayout's exactly (dtype included), and so does the packed state."""
    cfg_kw, scene, kw = {
        "dam_small": ({}, "dam", SMALL),
        # empty grid rows between the drop and the floor: zero-length runs
        "drop_small": ({}, "drop", SMALL),
        "pool_default": ({"r": 0.03}, "pool", {}),
        # qb=16 widens the windows past 128 lanes on this scene
        "dam_cap128": ({}, "dam", dict(tq=32, qb=16, cap=128, seg_q=2)),
    }[case]
    je, te, fluid = _engines(cfg_kw, scene, **kw)
    pk = np.asarray(je._initial_packed(fluid))
    jpk, jctx, jov = jax.jit(je._relayout)(jnp.asarray(pk))
    tpk, tctx, tov = te._relayout(torch.tensor(pk))
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    for f in ("layout_src", "trip_src", "w_start", "w_len", "flen", "T",
              "overflow"):
        a, b = np.asarray(getattr(jctx, f)), getattr(tctx, f).numpy()
        assert b.dtype == a.dtype == np.int32, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert int(tov) == int(jov)
    if case == "dam_cap128":
        assert int(tov) > 0        # window truncation is counted


def _jitter(cfg, fluid):
    """Seeded position jitter (+-0.1 R): irregular pair distances, and a
    few dozen compressed particles with p > 0."""
    rng = np.random.default_rng(0)
    d = np.float32(0.1 * cfg.r)
    x = np.asarray(fluid.x) + rng.uniform(-d, d, fluid.n).astype(np.float32)
    y = np.asarray(fluid.y) + rng.uniform(-d, d, fluid.n).astype(np.float32)
    return fluid._replace(x=jnp.asarray(x), y=jnp.asarray(y))


@pytest.fixture(scope="module")
def frame():
    """One relayout of the jittered drop scene with seeded random
    velocities (so the viscosity branch is live), and both packages' density
    candidates built from the same numpy rows."""
    je, te, fluid = _engines({}, "drop", _jitter, **SMALL)
    rng = np.random.default_rng(3)
    fluid = fluid._replace(
        u=jnp.asarray(rng.normal(0, 0.5, fluid.n).astype(np.float32)),
        v=jnp.asarray(rng.normal(0, 0.5, fluid.n).astype(np.float32)))
    pk, ctx, ov = jax.jit(je._relayout)(je._initial_packed(fluid))
    assert int(ov) == 0
    pk_np = np.asarray(pk)
    trip = np.asarray(ctx.trip_src)
    src_d = np.concatenate([
        np.concatenate([pk_np[:, [0, 1, 4]], np.zeros((len(pk_np), 1), np.float32)], 1),
        np.asarray(je.b_geo_d), np.asarray(je.inert_row_d)])
    geo_d = np.ascontiguousarray(src_d[trip])          # (L, 4)
    return je, te, pk_np, ctx, geo_d, trip


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_density_plain_matches_pallas(frame):
    """rho within rtol 1e-6 (the sums run in another order).  p and cp
    within rtol 1e-4 / atol 0.05 (test_window_engine.py:60-61) plus what
    rho's own tolerance implies through the Tait power: dp = 7 B
    (rho/rho0)^7 drho/rho, which near rho0 turns a one-ulp rho difference
    into ~1e-4 of p.  The epilogue itself is exact: the port's p and cp
    are bitwise the Tait EOS of its own rho.  geo8 columns 0-4 and 7 are
    copies, so bitwise."""
    je, te, pk, ctx, geo_d, _ = frame
    jg8, jrp = density_window_call(jnp.asarray(pk), jnp.asarray(geo_d.T),
                                   ctx.w_start, ctx.flen, je.cfg, je.spec,
                                   interpret=True)
    tg8, trp = wk.density_window(_t(pk), _t(geo_d), _t(ctx.w_start),
                                 _t(ctx.flen), te.cfg, te.spec)
    jg8, jrp, tg8, trp = np.asarray(jg8), np.asarray(jrp), tg8.numpy(), trp.numpy()
    rho, p = trp[:, 0], trp[:, 1]
    assert (jrp[:, 1] > 0).sum() >= 10       # the EOS branch is live
    np.testing.assert_allclose(rho, jrp[:, 0], rtol=1e-6)
    ratio7 = (rho.astype(np.float64) / te.cfg.rho_0) ** 7
    p_cond = 7.0 * te.cfg.tait_b * ratio7 * 1e-6
    assert np.all(np.abs(p - jrp[:, 1]) <= 0.05 + 1e-4 * np.abs(jrp[:, 1]) + p_cond)
    cp_cond = p_cond / np.maximum(rho.astype(np.float64), 1.0) ** 2
    assert np.all(np.abs(tg8[:, 5] - jg8[:, 5]) <= 1e-7 + 1e-4 * np.abs(jg8[:, 5]) + cp_cond)
    c = wk.density_consts(te.cfg)
    ratio = rho * np.float32(c["inv_rho0"])
    rr2 = ratio * ratio
    rr4 = rr2 * rr2
    p_ref = np.maximum(np.float32(c["tait_b"]) * (rr4 * rr2 * ratio - np.float32(1)), 0)
    np.testing.assert_array_equal(p, p_ref)
    np.testing.assert_array_equal(tg8[:, 6], np.float32(0.5) * rho)
    np.testing.assert_allclose(tg8[:, 6], jg8[:, 6], rtol=1e-6)
    np.testing.assert_array_equal(tg8[:, [0, 1, 2, 3, 4, 7]], jg8[:, [0, 1, 2, 3, 4, 7]])
    assert wk.density_window.launches == 0


@pytest.mark.parametrize("half_dt_frac,damp", [(0.5, 0.97), (0.0, 1.0)])
def test_forces_plain_matches_pallas(frame, half_dt_frac, damp):
    """acc rtol 2e-5 / atol 2e-4 (test_window_engine.py:70-73); u' and v'
    within half_dt times the acc tolerance, plus 2 ulp of u'.  With
    half_dt = 0, damp = 1 (the priming pass) u and v are bitwise unchanged.
    Both packages take the same density outputs and force candidates."""
    je, te, pk, ctx, geo_d, trip = frame
    geo8, rp = density_window_call(jnp.asarray(pk), jnp.asarray(geo_d.T),
                                   ctx.w_start, ctx.flen, je.cfg, je.spec,
                                   interpret=True)
    geo8, rp = np.asarray(geo8), np.asarray(rp)
    src_f = np.concatenate([geo8, np.asarray(je.b_geo), np.asarray(je.inert_row)])
    geo_f = np.ascontiguousarray(src_f[trip])           # (L, 8)
    half_dt = half_dt_frac * float(je.cfg.dt)
    jpk, jacc = forces_window_call(
        jnp.asarray(pk), jnp.asarray(geo8), jnp.asarray(rp),
        jnp.asarray(geo_f.T), ctx.w_start, ctx.flen,
        jnp.asarray(G, jnp.float32), je.cfg, je.spec, half_dt=half_dt,
        damp=damp, interpret=True)
    tpk, tacc = wk.forces_window(_t(pk), _t(geo8), _t(rp), _t(geo_f),
                                 _t(ctx.w_start), _t(ctx.flen), G, te.cfg,
                                 te.spec, half_dt=half_dt, damp=damp)
    jpk, jacc, tpk, tacc = (np.asarray(jpk), np.asarray(jacc), tpk.numpy(),
                            tacc.numpy())
    np.testing.assert_allclose(tacc, jacc, rtol=2e-5, atol=2e-4)
    bound = (np.float32(half_dt) * (2e-4 + 2e-5 * np.abs(jacc))
             + 2 * np.spacing(np.abs(jpk[:, 2:4])))
    assert np.all(np.abs(tpk[:, 2:4] - jpk[:, 2:4]) <= bound)
    np.testing.assert_array_equal(tpk[:, [0, 1, 4, 5, 6, 7]], jpk[:, [0, 1, 4, 5, 6, 7]])
    if half_dt == 0.0:
        np.testing.assert_array_equal(tpk[:, 2:4], pk[:, 2:4])
    real = pk[:, 4] > 0
    assert np.isfinite(tacc).all() and (tacc[~real] == 0).all()
    assert wk.forces_window.launches == 0


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor on a device with no kernel raises."""
    te = _engines({}, "drop", **SMALL)[1]
    s = te.spec
    meta = dict(device="meta")
    q = torch.empty((s.n_layout, 8), **meta)
    ws = torch.empty((s.n_tiles, s.nqb), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no window kernel"):
        wk.density_window(q, torch.empty((s.L, 4), **meta), ws, ws, te.cfg, s)
    with pytest.raises(ValueError, match="no window kernel"):
        wk.forces_window(q, q, torch.empty((s.n_layout, 2), **meta),
                         torch.empty((s.L, 8), **meta), ws, ws, G, te.cfg, s)
    with pytest.raises(ValueError, match="int32"):
        wk.density_window(torch.zeros((s.n_layout, 8)), torch.zeros((s.L, 4)),
                          torch.zeros((s.n_tiles, s.nqb)),
                          torch.zeros((s.n_tiles, s.nqb), dtype=torch.int32),
                          te.cfg, s)
