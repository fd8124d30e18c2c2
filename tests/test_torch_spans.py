"""The per-block span table of the port (ops/window/triple.py::block_spans)
and the plain window passes that read their candidates through it.

The kernels are maskless, so correctness rests on the structure: every true
neighbour (fluid or boundary, within the support radius) of every real
query must lie in exactly one lane of its block's spans (the property of
tests/test_triple.py, on the same randomized scenes), the spans must name
the rows of the JAX package's window and nothing else, and a truncated
window keeps its first cap lanes in span order.  Imports JAX only to lay
the same scene out through the JAX package."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine as JEngine

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import convert
from pi_sph_fluid_tpu_torch.ops.window import window_kernels as wk

torch.set_num_threads(1)

G = (0.0, -9.81)
KW = dict(tq=32, qb=8, cap=256, seg_q=2)


def _engine(n, **kw):
    cfg = T.SPHConfig()
    b, bg = T.prepare_boundary(T.build_drop_scene(cfg, "cpu")[1], cfg)
    return T.WindowEngine(cfg, b, bg, n, "cpu", **{**KW, **kw})


def _positions(seed, n=300, clustered=False):
    """The randomized scenes of tests/test_triple.py: uniform, or a dense
    blob plus sparse dust (window caps and empty grid rows)."""
    rng = np.random.default_rng(seed)
    if clustered:
        blob = rng.normal([1.0, 0.5], 0.1, size=(n // 2, 2))
        dust = rng.uniform([0.1, 0.1], [3.9, 1.9], size=(n - n // 2, 2))
        pos = np.concatenate([blob, dust]).astype(np.float32)
    else:
        pos = rng.uniform([0.05, 0.05], [3.95, 1.95], size=(n, 2)).astype(np.float32)
    pos[:, 0] = np.clip(pos[:, 0], 0.01, 3.99)
    pos[:, 1] = np.clip(pos[:, 1], 0.01, 1.99)
    return pos


def _fluid(cfg, pos):
    one = torch.ones(len(pos))
    return T.FluidState(x=torch.tensor(pos[:, 0]), y=torch.tensor(pos[:, 1]),
                        u=0 * one, v=0 * one, m=cfg.particle_mass * one,
                        rho=cfg.rho_0 * one, p=0 * one)


def _span_rows(spans_b, n_layout):
    """Source rows (fluid layout rows, then n_layout + boundary rows) under
    one block's spans, in span order."""
    cover = len(spans_b) // 2
    return np.concatenate([np.arange(s, s + n) + (n_layout if k >= cover else 0)
                           for k, (s, n) in enumerate(spans_b)]).astype(np.int64)


@pytest.mark.parametrize("seed,clustered,seg_q", [(0, False, 2), (1, True, 2),
                                                  (2, True, 2), (0, False, 3),
                                                  (1, True, 1)])
def test_every_true_pair_in_exactly_one_span_lane(seed, clustered, seg_q):
    pos = _positions(seed, clustered=clustered)
    eng = _engine(len(pos), seg_q=seg_q)
    pk, ctx, overflow = eng._relayout(eng._initial_packed(_fluid(eng.cfg, pos)))
    assert int(overflow) == 0
    spec, pk = eng.spec, pk.numpy()
    spans = ctx.spans.numpy()
    assert spans.shape == (spec.n_layout // spec.qb, 2 * (seg_q + 2), 2)
    b = eng.boundary
    src_x = np.concatenate([pk[:, 0], b.x.numpy()])
    src_y = np.concatenate([pk[:, 1], b.y.numpy()])
    src_m = np.concatenate([pk[:, 4], b.m.numpy()])
    support = np.float32(eng.cfg.support_radius)
    real = pk[:, 4] > 0
    seen = 0
    for blk in range(spec.n_layout // spec.qb):
        qs = np.nonzero(real[blk * spec.qb:(blk + 1) * spec.qb])[0] + blk * spec.qb
        if len(qs) == 0:
            assert (spans[blk, :, 1] == 0).all()      # pads only: no lanes
            continue
        rows = _span_rows(spans[blk], spec.n_layout)
        assert rows.min() >= 0 and rows.max() < len(src_x)
        for q in qs:
            d_src = np.sqrt((src_x - pk[q, 0]) ** 2 + (src_y - pk[q, 1]) ** 2)
            want = set(np.nonzero((d_src < support) & (src_m > 0))[0].tolist())
            d_win = np.sqrt((src_x[rows] - pk[q, 0]) ** 2 + (src_y[rows] - pk[q, 1]) ** 2)
            got = Counter(rows[(d_win < support) & (src_m[rows] > 0)].tolist())
            assert set(got) == want, (
                f"block {blk} query {q}: missing {want - set(got)}, "
                f"spurious {set(got) - want}")
            assert all(v == 1 for v in got.values()), f"block {blk} query {q}"
            seen += len(want)
    assert seen > len(pos)                             # neighbours beyond self


@pytest.mark.parametrize("scene", ["drop", "dam"])
def test_spans_name_the_jax_window_rows(scene):
    """On the JAX package's own relayout of the scene: sum(span len) ==
    w_len, and the rows under a block's spans are the rows of its window of
    JAX's trip_src (no inert row lies inside a window), as multisets."""
    jc = J.SPHConfig()
    build = {"drop": J.build_drop_scene, "dam": J.build_dam_break_scene}[scene]
    fluid, braw = build(jc)
    jb, jbg = J.prepare_boundary(braw, jc)
    je = JEngine(jc, jb, jbg, fluid.n, planes=1, band=0, interpret=True, **KW)
    pk = np.asarray(je._initial_packed(fluid))
    _, jctx, _ = jax.jit(je._relayout)(jnp.asarray(pk))
    te = T.WindowEngine(T.SPHConfig(), convert.boundary_state(jb, "cpu"),
                        convert.grid_context(jbg, "cpu"), fluid.n, "cpu", **KW)
    spans = te._relayout(torch.tensor(pk))[1].spans.numpy()
    trip = np.asarray(jctx.trip_src)
    w_start = np.asarray(jctx.w_start).reshape(-1)
    w_len = np.asarray(jctx.w_len).reshape(-1)
    np.testing.assert_array_equal(spans[:, :, 1].sum(1), w_len)
    for blk in np.nonzero(w_len)[0]:
        want = trip[w_start[blk]:w_start[blk] + w_len[blk]]
        assert (want < je.spec.n_src - 1).all()
        np.testing.assert_array_equal(
            np.sort(_span_rows(spans[blk], te.spec.n_layout)), np.sort(want))


def test_truncated_window_keeps_first_cap_lanes_in_span_order():
    """w_len > cap: the plain passes compute the first cap lanes in span
    order (the kernels' rule) and the relayout counts the rest."""
    cap = 24
    pos = _positions(1, clustered=True)
    eng = _engine(len(pos), cap=cap)
    pk, ctx, overflow = eng._relayout(eng._initial_packed(_fluid(eng.cfg, pos)))
    spec, spans = eng.spec, ctx.spans
    total = spans[:, :, 1].sum(1)
    assert int(overflow) == int((total - cap).clamp_min(0).sum()) > 0
    idx, valid = wk._span_lanes(spans, 0, spans.shape[0], cap, spec.n_layout,
                                eng.boundary.x.shape[0])
    assert idx.shape[1] == cap
    for blk in torch.nonzero(total > 0).reshape(-1).tolist():
        rows = _span_rows(spans[blk].numpy(), spec.n_layout)[:cap]
        n = len(rows)
        np.testing.assert_array_equal(idx[blk, :n].numpy(), rows)
        assert valid[blk, :n].all() and not valid[blk, n:].any()
    # the truncated density is the sum over exactly those lanes
    geo8, rp = wk.density_window(pk, eng._b_geo_d, spans, eng.cfg, spec)
    src = torch.cat([pk[:, [0, 1, 4]], eng._b_geo_d[:, :3]]).double()
    blk = int(torch.argmax(total))
    q = blk * spec.qb
    c = src[idx[blk][valid[blk]]]
    r = torch.sqrt((pk[q, 0].double() - c[:, 0]) ** 2 + (pk[q, 1].double() - c[:, 1]) ** 2)
    t1 = (1.0 - r / (2.0 * eng.cfg.h)).clamp_min(0.0)
    want = eng.cfg.kernel_norm * float((c[:, 2] * t1 ** 4 * (1.0 + 2.0 * r / eng.cfg.h)).sum())
    assert float(rp[q, 0]) == pytest.approx(want, rel=1e-5)


def test_spans_are_clamped_into_their_arrays():
    """A span that reaches outside its array is cut to it, never read past
    it (the kernels clamp the same way): garbage spans give finite output."""
    eng = _engine(40)
    pk, ctx, _ = eng._relayout(eng._initial_packed(
        _fluid(eng.cfg, _positions(0, n=40))))
    spans = ctx.spans.clone()
    spans[0, 0] = torch.tensor([-5, 7])                    # negative start
    spans[1, 1] = torch.tensor([eng.spec.n_layout - 2, 9])  # past the fluid rows
    spans[2, 4] = torch.tensor([eng.boundary.x.shape[0] - 1, 1 << 30])
    spans[3, 5] = torch.tensor([1 << 30, 4])
    spans[4, 2] = torch.tensor([3, -8])                    # negative length
    nb = eng.boundary.x.shape[0]
    idx, valid = wk._span_lanes(spans, 0, 8, eng.spec.cap, eng.spec.n_layout, nb)
    assert int(idx.min()) >= 0 and int(idx.max()) < eng.spec.n_layout + nb
    geo8, rp = wk.density_window(pk, eng._b_geo_d, spans, eng.cfg, eng.spec)
    assert torch.isfinite(rp).all()


def test_sticky_ticks_read_the_current_state():
    """Under a sticky layout the spans are the relayout's while the rows are
    the tick's: the passes of a carried tick see the drifted positions.  A
    uniform drift of 0.2 H (inside the 0.3 H guard) leaves every fluid-fluid
    distance alone but moves the fluid against the static boundary rows, so
    the density changes exactly where the boundary is in reach."""
    cfg = T.SPHConfig()
    fluid, _ = T.build_dam_break_scene(cfg, "cpu")
    eng = _engine(fluid.n)
    pk, ctx, _ = eng._relayout(eng._initial_packed(fluid))
    live = pk[:, 4] > 0
    moved = pk.clone()
    moved[live, 1] -= 0.2 * cfg.h
    _, rp_still = wk.density_window(pk, eng._b_geo_d, ctx.spans, cfg, eng.spec)
    _, rp_moved = wk.density_window(moved, eng._b_geo_d, ctx.spans, cfg, eng.spec)
    changed = (rp_moved[:, 0] - rp_still[:, 0]).abs() > 1e-3 * cfg.rho_0
    near_floor = live & (pk[:, 1] < 2.0 * cfg.h)
    far = live & (pk[:, 1] > 3.0 * cfg.h) & (pk[:, 0] > 3.0 * cfg.h)
    assert changed[near_floor].all() and near_floor.sum() > 10
    torch.testing.assert_close(rp_moved[far, 0], rp_still[far, 0], rtol=1e-5, atol=0)
    assert far.sum() > 10 and torch.isfinite(rp_moved[live]).all()
