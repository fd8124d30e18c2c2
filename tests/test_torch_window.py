"""Port vs the JAX package: the row-triple relayout (integer arrays, exact,
and the span table that names every window's rows) and the two window
passes (the port's plain versions, reading their candidates through the
spans, vs the Pallas kernels in interpret mode over the gathered windows,
on the same numpy-made inputs).

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
from pi_sph_fluid_tpu_torch.ops.window import relayout as rl
from pi_sph_fluid_tpu_torch.ops.window import window_kernels as wk
from pi_sph_fluid_tpu_torch.utils.tracer import tracer

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


def _on_floor(cfg, fluid):
    """The drop lowered to rest 2 R above the floor: every grid row above
    it, the last ones included, holds no fluid."""
    y = np.asarray(fluid.y)
    return fluid._replace(y=jnp.asarray(y - (y.min() - np.float32(2 * cfg.r))))


def _one_row(cfg, fluid):
    """Every particle of the drop in grid row 3, its x kept."""
    y = np.full(fluid.n, 3.5 * cfg.cell_length, np.float32)
    return fluid._replace(y=jnp.asarray(y))


def _pad_rows(cfg, fluid):
    """Every fifth particle of the drop a pad (m = 0) among the live ones."""
    m = np.asarray(fluid.m).copy()
    m[::5] = 0.0
    return fluid._replace(m=jnp.asarray(m))


# what each edge case must show of its packed state: (rows, m, live rows)
_EDGES = {
    "drop_trailing_empty": lambda rows, m, live: rows[live].max() <= m - 4,
    "drop_one_row": lambda rows, m, live: (rows[live] == 3).all(),
    "drop_pad_rows": lambda rows, m, live: (~live[:np.nonzero(live)[0].max()]).sum() > 40,
}


@pytest.mark.parametrize("case", ["dam_small", "drop_small", "pool_default",
                                  "dam_cap128", *_EDGES])
def test_relayout_integer_arrays_equal(case):
    """layout_src, w_start, w_len, flen, T and overflow equal the JAX
    relayout's exactly (dtype included), and so does the packed state; the
    port builds no trip_src, and its span table names the rows of every
    window of JAX's.  The last three cases are the edges the CUDA relayout
    meets: trailing grid rows with no fluid, every particle in one grid
    row, and pads (m = 0) among the live rows."""
    cfg_kw, scene, kw, fluid_fn = {
        "dam_small": ({}, "dam", SMALL, None),
        # empty grid rows between the drop and the floor: zero-length runs
        "drop_small": ({}, "drop", SMALL, None),
        "pool_default": ({"r": 0.03}, "pool", {}, None),
        # qb=16 widens the windows past 128 lanes on this scene
        "dam_cap128": ({}, "dam", dict(tq=32, qb=16, cap=128, seg_q=2), None),
        "drop_trailing_empty": ({}, "drop", SMALL, _on_floor),
        "drop_one_row": ({}, "drop", SMALL, _one_row),
        "drop_pad_rows": ({}, "drop", SMALL, _pad_rows),
    }[case]
    je, te, fluid = _engines(cfg_kw, scene, fluid_fn, **kw)
    pk = np.asarray(je._initial_packed(fluid))
    if case in _EDGES:
        live = pk[:, 4] > 0
        rows = np.floor(pk[:, 1] / np.float32(te.cfg.cell_length)).astype(int)
        assert _EDGES[case](rows, te.cfg.n_cell_rows, live), case
    jpk, jctx, jov = jax.jit(je._relayout)(jnp.asarray(pk))
    tpk, tctx, tov = te._relayout(torch.tensor(pk))
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    for f in ("layout_src", "w_start", "w_len", "flen", "T", "overflow"):
        a, b = np.asarray(getattr(jctx, f)), getattr(tctx, f).numpy()
        assert b.dtype == a.dtype == np.int32, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert int(tov) == int(jov)
    if case == "dam_cap128":
        assert int(tov) > 0        # window truncation is counted
    # the span table names the same rows as every block's window of JAX's
    # trip_src (row-major instead of column-major), bitwise
    spans = tctx.spans.numpy()
    n_layout, cover = te.spec.n_layout, te.spec.n_spans // 2
    assert spans.dtype == np.int32
    assert spans.shape == (n_layout // te.spec.qb, 2 * cover, 2)
    w_start = tctx.w_start.numpy().reshape(-1)
    w_len = tctx.w_len.numpy().reshape(-1)
    trip = np.asarray(jctx.trip_src)
    np.testing.assert_array_equal(spans[:, :, 1].sum(1), w_len)
    assert (spans[:, :, 1] >= 0).all()
    assert (w_len > 0).any() and (spans[:, :, 1] == 0).any()
    inert = je.spec.n_src - 1
    for b in np.nonzero(w_len)[0]:
        rows = [np.arange(s, s + n) + (n_layout if k >= cover else 0)
                for k, (s, n) in enumerate(spans[b])]
        want = trip[w_start[b]:w_start[b] + w_len[b]]
        want = want[want != inert]
        np.testing.assert_array_equal(np.sort(np.concatenate(rows)), np.sort(want))


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
    spans = te._relayout(torch.tensor(np.asarray(je._initial_packed(fluid))))[1].spans
    return je, te, pk_np, ctx, geo_d, trip, spans


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
    je, te, pk, ctx, geo_d, _, spans = frame
    jg8, jrp = density_window_call(jnp.asarray(pk), jnp.asarray(geo_d.T),
                                   ctx.w_start, ctx.flen, je.cfg, je.spec,
                                   interpret=True)
    tg8, trp = wk.density_window(_t(pk), te._b_geo_d, spans, te.cfg, te.spec)
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
    assert tracer.counters.get("kernel.density.launches", 0) == 0


@pytest.mark.parametrize("half_dt_frac,damp", [(0.5, 0.97), (0.0, 1.0)])
def test_forces_plain_matches_pallas(frame, half_dt_frac, damp):
    """acc rtol 2e-5 / atol 2e-4 (test_window_engine.py:70-73); u' and v'
    within half_dt times the acc tolerance, plus 2 ulp of u'.  With
    half_dt = 0, damp = 1 (the priming pass) u and v are bitwise unchanged.
    Both packages take the same density outputs; JAX reads the gathered
    force candidates, the port the same rows through the spans."""
    je, te, pk, ctx, geo_d, trip, spans = frame
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
    np.testing.assert_array_equal(te._b_geo_f.numpy(), np.asarray(je.b_geo))
    tpk, tacc = wk.forces_window(_t(pk), _t(geo8), _t(rp), te._b_geo_f, spans,
                                 G, te.cfg, te.spec, half_dt=half_dt, damp=damp)
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
    assert tracer.counters.get("kernel.forces.launches", 0) == 0


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor on a device with no kernel raises, and
    so does an argument of the wrong type, shape or layout."""
    te = _engines({}, "drop", **SMALL)[1]
    s = te.spec
    meta = dict(device="meta")
    q = torch.empty((s.n_layout, 8), **meta)
    sp = torch.empty((s.n_layout // s.qb, s.n_spans, 2), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no window kernel"):
        wk.density_window(q, torch.empty((5, 4), **meta), sp, te.cfg, s)
    with pytest.raises(ValueError, match="no window kernel"):
        wk.forces_window(q, q, torch.empty((s.n_layout, 2), **meta),
                         torch.empty((5, 8), **meta), sp, G, te.cfg, s)
    q, sp = torch.zeros((s.n_layout, 8)), torch.zeros(sp.shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        wk.density_window(q, te._b_geo_d, sp.float(), te.cfg, s)
    with pytest.raises(ValueError, match="spans"):
        wk.density_window(q, te._b_geo_d, sp[:, :-1], te.cfg, s)
    with pytest.raises(ValueError, match="boundary rows"):
        wk.density_window(q, te._b_geo_f, sp, te.cfg, s)
    with pytest.raises(ValueError, match="not contiguous"):
        wk.forces_window(q, q.T.contiguous().T, torch.zeros((s.n_layout, 2)),
                         te._b_geo_f, sp, G, te.cfg, s)
    with pytest.raises(ValueError, match="n_spans"):
        wk.density_window(q, te._b_geo_d, torch.zeros((sp.shape[0], 34, 2),
                                                      dtype=torch.int32),
                          te.cfg, s._replace(seg_q=15))


def test_relayout_wrapper_plain_on_cpu_raises_elsewhere():
    """The relayout wrapper runs the plain chain on CPU tensors, bitwise,
    and counts no kernel relayout; a tensor on a device with no kernel
    raises, and so does an argument of the wrong type, shape or layout."""
    je, te, fluid = _engines({}, "drop", _pad_rows, **SMALL)
    pk = torch.tensor(np.asarray(je._initial_packed(fluid)))
    fixed = (te.b_cell_starts, te._b_grid, te._inert_row)
    before = tracer.counters.get("kernel.relayout.launches", 0)
    got = rl.relayout(te.spec, te.cfg, pk, *fixed)
    want = rl.relayout_plain(te.spec, te.cfg, pk, *fixed)
    assert tracer.counters.get("kernel.relayout.launches", 0) == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    assert torch.equal(got[2], want[2])
    for f in got[1]._fields:
        assert torch.equal(getattr(got[1], f), getattr(want[1], f)), f
    meta = [t.to("meta") for t in (pk, *fixed)]
    with pytest.raises(ValueError, match="no relayout kernel"):
        rl.relayout(te.spec, te.cfg, *meta)
    with pytest.raises(ValueError, match="float32"):
        rl.relayout(te.spec, te.cfg, pk.double(), *fixed)
    with pytest.raises(ValueError, match="not contiguous"):
        rl.relayout(te.spec, te.cfg, pk.T.contiguous().T, *fixed)
    with pytest.raises(ValueError, match="b_grid"):
        rl.relayout(te.spec, te.cfg, pk, fixed[0], fixed[1][:-1], fixed[2])
    with pytest.raises(ValueError, match="inert_row"):
        rl.relayout(te.spec, te.cfg, pk, *fixed[:2], fixed[2][0])
