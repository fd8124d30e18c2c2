"""Port vs the JAX package: the metaball renderers.

The pixel layout and the pixel windows are integer arrays and must be
bitwise JAX's; the field (the port's plain version of the field kernel
against the Pallas kernel in interpret mode) agrees within the JAX
renderer's own gates (test_render_window.py:55-99); framebuffers from the C
golden positions agree with the C dumps as test_render.py:72 and
test_parity_3k.py:194 require.  The same numpy-made states feed both
packages."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine as JEngine
from pi_sph_fluid_tpu.models.scene import pixel_centers as j_pixel_centers
from pi_sph_fluid_tpu.ops.grid import build_grid as j_build_grid
from pi_sph_fluid_tpu.render import metaballs_window as jmw
from pi_sph_fluid_tpu.render.metaballs import metaball_field as j_metaball_field
from pi_sph_fluid_tpu.render.metaballs import pack_framebuffer as j_pack

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import convert
from pi_sph_fluid_tpu_torch.ops.grid import build_grid, cell_ids
from pi_sph_fluid_tpu_torch.ops.window import triple as ttriple
from pi_sph_fluid_tpu_torch.ops.window import window_kernels as twk
from pi_sph_fluid_tpu_torch.render import metaballs as tm
from pi_sph_fluid_tpu_torch.render import metaballs_window as tmw
from pi_sph_fluid_tpu_torch.utils.tracer import tracer

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
G = (0.0, -9.81)
KW = dict(tq=32, qb=8, cap=256, seg_q=2)


@pytest.fixture(scope="module")
def drop():
    """The drop through both engines (exact-start JAX layout), the JAX
    primed state, and a renderer on each side."""
    cfg = J.SPHConfig()
    fluid, braw = J.build_drop_scene(cfg)
    b, bg = J.prepare_boundary(braw, cfg)
    je = JEngine(cfg, b, bg, fluid.n, planes=1, band=0, interpret=True, **KW)
    te = T.WindowEngine(T.SPHConfig(), convert.boundary_state(b, "cpu"),
                        convert.grid_context(bg, "cpu"), fluid.n, "cpu", **KW)
    jsim = je.prime(fluid, G)
    return je, te, jsim, jmw.WindowRenderer(je, 64, 128), T.WindowRenderer(te, 64, 128)


def _assert_field(ours, ref, atol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, atol=atol)
    confident = np.abs(ref - 1.0) > 1e-3
    np.testing.assert_array_equal(ours[confident] >= 1.0, ref[confident] >= 1.0)


@pytest.mark.parametrize("r", [0.075, 0.0226])
@pytest.mark.parametrize("rows,cols", [(64, 128), (256, 128)])
def test_pixel_layout_bitwise(r, rows, cols):
    """pixel_centers and every pixel_layout array equal JAX's, bitwise and
    dtype included; so do the window cap and the field scale (the latter
    at the 128-column pitch for every raster)."""
    jc, tc = J.SPHConfig(r=r), T.SPHConfig(r=r)
    jpx, jpy = j_pixel_centers(jc, rows, cols)
    tpx, tpy = T.pixel_centers(tc, rows, cols)
    np.testing.assert_array_equal(tpx, jpx)
    np.testing.assert_array_equal(tpy, jpy)
    ja = jmw.pixel_layout(jc, jpx, jpy, 8, 64)
    ta = tmw.pixel_layout(tc, tpx, tpy, 8, 64)
    assert ta["n_layout"] == ja["n_layout"]
    for key in ("q", "slots", "c_first", "c_last", "has_q"):
        assert ta[key].dtype == ja[key].dtype, key
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)
    assert tmw.pixel_window_cap(tc, cols, 8, 2) == jmw.pixel_window_cap(jc, cols, 8, 2)
    assert tmw.field_scale_of(tc) == jmw.field_scale_of(jc)


def test_pixel_windows_exact_start(drop):
    """On one relayout frame (T bitwise JAX's), the pixel windows are the
    exact-start values derived from JAX's T: w_start = T[c_first, 0],
    w_len = T[c_last, 1] - T[c_first, 0]; overflow 0 on both sides."""
    je, te, jsim, jr, tr = drop
    pk = np.asarray(je._initial_packed(J.build_drop_scene(je.cfg)[0]))
    _, jctx, _ = jax.jit(je._relayout)(jnp.asarray(pk))
    _, tctx, _ = te._relayout(torch.tensor(pk))
    jT = np.asarray(jctx.T)
    np.testing.assert_array_equal(tctx.T.numpy(), jT)
    ws, wl, ov = tmw.pixel_windows(tctx.T, tr.c_first, tr.c_last, tr.has_q,
                                   tr.reuse_spec.cap, te.cfg.n_cells)
    c_first, c_last = np.asarray(jr.blk_c_first), np.asarray(jr.blk_c_last)
    has_q = np.asarray(jr.blk_has_q)
    want_start = np.where(has_q, jT[c_first, 0], 0)
    want_len = np.where(has_q, jT[c_last, 1] - jT[c_first, 0], 0)
    assert ws.dtype == wl.dtype == torch.int32
    np.testing.assert_array_equal(ws.numpy(), want_start)
    np.testing.assert_array_equal(wl.numpy(), want_len)
    assert int(ov) == 0
    _, _, jov = jmw.pixel_windows(jctx.T, jr.blk_c_first, jr.blk_c_last,
                                  jr.blk_has_q, jr.reuse_spec.cap,
                                  je.spec.L + jr.reuse_spec.cap, je.cfg.n_cells)
    assert int(jov) == 0


def test_field_matches_jax(drop):
    """The self-relayout field on the same state: atol 5e-5, lit pixels
    identical wherever |field - 1| > 1e-3."""
    je, te, jsim, jr, tr = drop
    jf, jov = jax.jit(jr.field)(jsim)
    tf, tov = tr.field(convert.packed_sim(jsim, "cpu"))
    assert int(jov) == int(tov) == 0
    _assert_field(tf.numpy(), jf, 5e-5)
    assert tracer.counters.get("kernel.field.launches", 0) == 0


def test_field_from_frame_matches_jax(drop):
    """The frame-reuse field on the same state and the same relayout (three
    exact ticks of the JAX engine; convert.frame derives the port's frame
    from the layout-fresh state and holds its T against JAX's, bitwise).
    JAX gathers the windows and runs the Pallas kernel in interpret mode;
    the port reads the same fluid rows through the spans."""
    je, te, jsim, jr, tr = drop
    multi = jax.jit(je.make_multi_step(return_frame=True))
    gt = jnp.broadcast_to(jnp.asarray(G, jnp.float32), (3, 2))
    jsim3, _, jframe = multi(jsim, gt)
    jf, jov = jax.jit(jr.field_from_frame)(jsim3, jframe)
    tsim3 = convert.packed_sim(jsim3, "cpu")
    frame = convert.frame(te, tsim3, jframe)
    np.testing.assert_array_equal(frame.T.numpy(), np.asarray(jframe[1]))
    tf, tov = tr.field_from_frame(tsim3, frame)
    assert int(jov) == int(tov) == 0
    _assert_field(tf.numpy(), jf, 5e-5)
    assert tracer.counters.get("kernel.field.launches", 0) == 0
    # a frame whose T is not this state's own is refused
    with pytest.raises(ValueError, match="layout-fresh"):
        convert.frame(te, tsim3, (jframe[0], np.asarray(jframe[1]) + 1))


def test_field_from_frame_sticky_stale(drop):
    """resort_every=4: the reused frame is 3 ticks stale, so against the
    port's own self-relayout field only fringe terms may differ (JAX's gate,
    test_render_window.py:82-99: atol 5e-3, >= 99.9% lit agreement)."""
    je, te, jsim, jr, tr = drop
    sim = convert.packed_sim(jsim, "cpu")
    sim, st, frame = te.make_multi_step(resort_every=4, return_frame=True)(
        sim, np.tile(np.float32(G), (8, 1)))
    assert int(st.neighbor_overflow.max()) == 0
    f_reuse, ov = tr.field_from_frame(sim, frame)
    assert int(ov) == 0
    f_self, _ = tr.field(sim)
    np.testing.assert_allclose(f_reuse.numpy(), f_self.numpy(), atol=5e-3)
    assert ((f_reuse >= 1.0) == (f_self >= 1.0)).double().mean() >= 0.999


def test_field_matches_brute_force(drop):
    """The port's field against a dense numpy sum over every particle
    (test_render_window.py:55)."""
    je, te, jsim, jr, tr = drop
    sim = convert.packed_sim(jsim, "cpu")
    field, _ = tr.field(sim)
    px, py = T.pixel_centers(te.cfg)
    fl = te.unpad(sim)
    q = np.sqrt((px[:, None] - fl.x.numpy()[None]) ** 2
                + (py[:, None] - fl.y.numpy()[None]) ** 2) / np.float32(te.cfg.h)
    t1 = np.maximum(1 - 0.5 * q, 0)
    w = np.float32(te.cfg.kernel_norm) * t1 ** 4 * (1 + 2 * q)
    np.testing.assert_allclose(field.numpy(), w.sum(1) / tm.w_ref_of(te.cfg), atol=5e-5)


def test_render_packs_the_field(drop):
    """render() is the thresholded, page-packed field; render_from_frame
    likewise over a frame."""
    je, te, jsim, jr, tr = drop
    sim = convert.packed_sim(jsim, "cpu")
    fb, ov = tr.render(sim)
    field, _ = tr.field(sim)
    assert fb.dtype == torch.uint8 and fb.shape == (1024,) and int(ov) == 0
    np.testing.assert_array_equal(T.unpack_framebuffer(fb.numpy()),
                                  (field >= 1.0).reshape(64, 128).numpy())
    sim, _, frame = te.make_multi_step(return_frame=True)(sim, np.float32([G]))
    fb, ov = tr.render_from_frame(sim, frame)
    field, _ = tr.field_from_frame(sim, frame)
    assert int(ov) == 0
    np.testing.assert_array_equal(T.unpack_framebuffer(fb.numpy()),
                                  (field >= 1.0).reshape(64, 128).numpy())


def _golden_sim(te, gs):
    fl = T.FluidState(*(torch.tensor(gs[:, j]) for j in range(7)))
    packed = te._initial_packed(fl)
    zero = torch.zeros(te.n_layout)
    return T.PackedSim(packed=packed, ids=packed[:, 7].to(torch.int32), au=zero, av=zero)


@pytest.mark.parametrize("renderer", ["window", "oracle"])
@pytest.mark.parametrize("golden,r,dumps,oracle_cap", [
    ("golden_drop.npz", 0.075, (20, 50, 100, 150, 200), 64),
    ("golden_drop_3k.npz", 0.0226, (10, 20), 128),
])
def test_golden_framebuffers(renderer, golden, r, dumps, oracle_cap):
    """Fields from the C golden positions, thresholded, agree >= 99.5% with
    the C framebuffer dumps and exactly away from the threshold
    (test_render.py:72, test_parity_3k.py:194)."""
    g = np.load(FIXTURES / golden)
    cfg = T.SPHConfig(r=r)
    if renderer == "window":
        _, braw = T.build_drop_scene(cfg, "cpu")
        b, bg = T.prepare_boundary(braw, cfg)
        te = T.WindowEngine(cfg, b, bg, g["states"].shape[1], "cpu", **KW)
        tr = T.WindowRenderer(te)
    px, py = (torch.as_tensor(a) for a in T.pixel_centers(cfg))
    for dump in dumps:
        gs = g["states"][dump]
        if renderer == "window":
            field, ov = tr.field(_golden_sim(te, gs))
            assert int(ov) == 0
        else:
            x, y = torch.tensor(gs[:, 0]), torch.tensor(gs[:, 1])
            order = build_grid(x, y, cfg).order.long()
            xs, ys = x[order], y[order]
            field = tm.metaball_field(px, py, xs, ys, build_grid(xs, ys, cfg),
                                      cfg, cap=oracle_cap)
        ours = field.numpy() >= 1.0
        theirs = T.unpack_framebuffer(g["framebuffers"][dump]).ravel()
        assert (ours == theirs).mean() >= 0.995, f"dump {dump}"
        confident = np.abs(field.numpy() - 1.0) > 1e-3
        np.testing.assert_array_equal(ours[confident], theirs[confident])


def test_oracle_field_matches_jax(drop):
    """The oracle metaball field on the drop equals JAX's to float32
    rounding of the same sums (rtol 1e-5 plus 1e-6 of the lit threshold)."""
    cfg = J.SPHConfig()
    fluid, _ = J.build_drop_scene(cfg)
    x, y = np.asarray(fluid.x), np.asarray(fluid.y)
    px, py = j_pixel_centers(cfg)
    jg = j_build_grid(jnp.asarray(x), jnp.asarray(y), cfg)
    xs, ys = x[np.asarray(jg.order)], y[np.asarray(jg.order)]
    jf = j_metaball_field(jnp.asarray(px), jnp.asarray(py), jnp.asarray(xs),
                          jnp.asarray(ys), j_build_grid(
                              jnp.asarray(xs), jnp.asarray(ys), cfg), cfg)
    tc = T.SPHConfig()
    txs, tys = torch.tensor(xs), torch.tensor(ys)
    tf = tm.metaball_field(torch.tensor(px), torch.tensor(py), txs, tys,
                           build_grid(txs, tys, tc), tc)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)


# ---- oracle renderer unit cases (ports of test_render.py:28-57) ----------


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    lit = rng.random((64, 128)) > 0.5
    buf = T.pack_framebuffer(torch.tensor(lit), 64, 128)
    assert buf.shape == (1024,) and buf.dtype == torch.uint8
    np.testing.assert_array_equal(T.unpack_framebuffer(buf.numpy()), lit)
    jbuf = j_pack(jnp.asarray(lit), 64, 128)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


def test_pack_layout_matches_ssd1306_pages():
    # only row i=10, col j=5 lit -> byte (10//8)*128+5 = 133, bit 10%8 = 2
    lit = torch.zeros((64, 128), dtype=torch.bool)
    lit[10, 5] = True
    buf = T.pack_framebuffer(lit, 64, 128).numpy()
    assert buf[1 * 128 + 5] == 1 << 2
    assert buf.sum() == 1 << 2


def test_single_particle_lights_its_pixel():
    """A particle on pixel (31, 64)'s center: field W(0)/W(px/2) > 1."""
    cfg = T.SPHConfig()
    x = torch.tensor([(64 + 0.5) * 4.0 / 128])
    y = torch.tensor([(64 - 31.5) * 2.0 / 64])
    f = T.FluidState(x=x, y=y, u=x * 0, v=x * 0, m=x * 0 + 1, rho=x * 0 + 1000, p=x * 0)
    img = T.unpack_framebuffer(T.make_renderer(cfg)(f).numpy())
    assert img[31, 64]
    assert not img[:8, :8].any()


def test_field_window_raises_off_cpu_and_cuda(drop):
    """No silent fallback: a tensor on a device with no kernel raises, and
    so does an argument of the wrong type, shape or layout."""
    te, tr = drop[1], drop[4]
    s = tr.reuse_spec
    meta = dict(device="meta")
    idx = torch.empty((s.n_layout // s.qb, s.seg_q + 2, 2), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no window kernel"):
        tmw.field_window(torch.empty((s.n_layout, 8), **meta),
                         torch.empty((64, 8), **meta),
                         torch.empty(9, dtype=torch.int32, **meta), idx, tr.cfg, s)
    rows = torch.zeros((te.n_layout, 8))
    grid = torch.zeros(te.cfg.n_cell_rows * (te.cfg.n_cell_cols + 1), dtype=torch.int32)
    idx = tr.reuse_span_idx
    assert tmw.field_window(tr.q_packed, rows, grid, idx, tr.cfg, s).shape == (s.n_layout,)
    with pytest.raises(ValueError, match="int32"):
        tmw.field_window(tr.q_packed, rows, grid.long(), idx, tr.cfg, s)
    with pytest.raises(ValueError, match="int32"):
        tmw.field_window(tr.q_packed, rows, grid, idx.long(), tr.cfg, s)
    with pytest.raises(ValueError, match="span_idx"):
        tmw.field_window(tr.q_packed, rows, grid, idx[:, :-1].contiguous(), tr.cfg, s)
    with pytest.raises(ValueError, match="source rows"):
        tmw.field_window(tr.q_packed, rows[:, :4].contiguous(), grid, idx, tr.cfg, s)
    with pytest.raises(ValueError, match="start grid"):
        tmw.field_window(tr.q_packed, rows, grid.reshape(1, -1), idx, tr.cfg, s)
    with pytest.raises(ValueError, match="not contiguous"):
        tmw.field_window(tr.q_packed, rows, grid, idx.transpose(0, 1).contiguous()
                         .transpose(0, 1), tr.cfg, s)
    with pytest.raises(ValueError, match="q_packed"):
        tmw.field_window(tr.q_packed[:-8], rows, grid, idx, tr.cfg, s)


# ---- the span-fed field kernel's inputs ----------------------------------


def _span_rows(grid, idx_b):
    """Source rows under one block's index pairs, in span order."""
    return np.concatenate([np.arange(grid[lo], grid[hi]) for lo, hi in idx_b]
                          + [np.zeros(0, np.int64)]).astype(np.int64)


@pytest.mark.parametrize("seg_q", [1, 2, 3])
@pytest.mark.parametrize("rows,cols", [(64, 128), (256, 128)])
def test_pixel_spans_name_the_fluid_rows_of_the_jax_window(rows, cols, seg_q):
    """On the JAX engine's own relayout of the dam break: the rows under a
    pixel block's spans (static index pairs into the port's start grid) are
    exactly the fluid rows of JAX's trip_src[w_start : w_start + w_len], as
    multisets, for every pixel block, at both rasters and each segment
    height; the boundary and inert lanes of the window are the rest."""
    kw = dict(KW, seg_q=seg_q)
    jc = J.SPHConfig()
    fluid, braw = J.build_dam_break_scene(jc)
    b, bg = J.prepare_boundary(braw, jc)
    je = JEngine(jc, b, bg, fluid.n, planes=1, band=0, interpret=True, **kw)
    te = T.WindowEngine(T.SPHConfig(), convert.boundary_state(b, "cpu"),
                        convert.grid_context(bg, "cpu"), fluid.n, "cpu", **kw)
    pk = np.asarray(je._initial_packed(fluid))
    _, jctx, _ = jax.jit(je._relayout)(jnp.asarray(pk))
    _, tctx, _ = te._relayout(torch.tensor(pk))
    trip, jT = np.asarray(jctx.trip_src), np.asarray(jctx.T)
    lay = jmw.pixel_layout(jc, *j_pixel_centers(jc, rows, cols), 8, 64)
    c_first, c_last, has_q = lay["c_first"], lay["c_last"], lay["has_q"]
    idx = ttriple.span_index(te.cfg, seg_q, torch.tensor(c_first),
                             torch.tensor(c_last), torch.tensor(has_q))
    assert idx.dtype == torch.int32 and idx.shape == (len(c_first), seg_q + 2, 2)
    grid = tctx.start_grid.numpy()
    assert grid.shape == (te.cfg.n_cell_rows * (te.cfg.n_cell_cols + 1),)
    n_layout, seen = te.spec.n_layout, 0
    for blk in range(len(c_first)):
        got = _span_rows(grid, idx[blk].numpy())
        if not has_q[blk]:
            assert len(got) == 0
            continue
        w0 = jT[c_first[blk], 0]
        window = trip[w0:jT[c_last[blk], 1]]
        np.testing.assert_array_equal(np.sort(got), np.sort(window[window < n_layout]))
        seen += len(got)
    assert seen > fluid.n                    # windows overlap: rows repeat


def test_engine_and_renderer_share_the_span_definition(drop):
    """The fluid half of the engine's span table is the start grid read
    through span_index of the engine's own blocks."""
    te = drop[1]
    pk, ctx, _ = te._relayout(te._initial_packed(T.build_drop_scene(te.cfg, "cpu")[0]))
    cells = torch.where(pk[:, 4] > 0, cell_ids(pk[:, 0], pk[:, 1], te.cfg),
                        torch.full_like(pk[:, 4], te.cfg.n_cells, dtype=torch.int32))
    idx = ttriple.span_index(te.cfg, te.spec.seg_q,
                             *ttriple._block_cells(te.spec, te.cfg, cells)).long()
    cover = te.spec.seg_q + 2
    start = ctx.start_grid[idx[:, :, 0]]
    torch.testing.assert_close(ctx.spans[:, :cover, 0], start, rtol=0, atol=0)
    torch.testing.assert_close(ctx.spans[:, :cover, 1],
                               ctx.start_grid[idx[:, :, 1]] - start, rtol=0, atol=0)


def _brute_field(cfg, x, y, rows=64, cols=128):
    px, py = T.pixel_centers(cfg, rows, cols)
    q = np.sqrt((px[:, None] - x[None]) ** 2
                + (py[:, None] - y[None]) ** 2) / np.float32(cfg.h)
    t1 = np.maximum(1 - 0.5 * q, 0)
    w = np.float32(cfg.kernel_norm) * t1 ** 4 * (1 + 2 * q)
    return w.sum(1) * tmw.field_scale_of(cfg) / np.float32(cfg.kernel_norm)


@pytest.mark.parametrize("seg_q", [2, 3])
def test_fields_at_256x128_match_brute_force(drop, seg_q):
    """Both modes at the fine raster against a dense numpy sum, with the
    engine's segment height equal to the renderer's (one index table) and
    different from it (one table per mode)."""
    te0, jsim = drop[1], drop[2]
    b, bg = T.prepare_boundary(T.build_drop_scene(te0.cfg, "cpu")[1], te0.cfg)
    te = T.WindowEngine(te0.cfg, b, bg, te0.n_real, "cpu", **dict(KW, seg_q=seg_q))
    tr = T.WindowRenderer(te, 256, 128)
    assert (tr.reuse_span_idx is tr.span_idx) == (seg_q == 2)
    assert tr.reuse_span_idx.shape[1] == seg_q + 2 and tr.span_idx.shape[1] == 4
    fluid = te0.unpad(convert.packed_sim(jsim, "cpu"))
    sim, _, frame = te.make_multi_step(return_frame=True)(
        te.prime(fluid, G), np.float32([G]))
    assert isinstance(frame, ttriple.Frame)
    fl = te.unpad(sim)
    want = _brute_field(te.cfg, fl.x.numpy(), fl.y.numpy(), 256, 128)
    for field, ov in (tr.field(sim), tr.field_from_frame(sim, frame)):
        assert int(ov) == 0
        np.testing.assert_allclose(field.numpy(), want, atol=5e-5)


def test_truncated_pixel_window_counts_overflow_and_keeps_first_lanes(drop):
    """w_len > cap: the overflow counts every lane of the window (fluid and
    boundary) beyond the cap, as JAX's pixel_windows does on the same T, and
    the field is the sum over the first cap fluid lanes in span order (JAX
    keeps the first cap lanes of its column-major window instead)."""
    je, te, jsim, jr, tr0 = drop
    tr = T.WindowRenderer(te, 64, 128)
    cap = 16
    tr.reuse_spec = tr.reuse_spec._replace(cap=cap)
    sim = convert.packed_sim(jsim, "cpu")
    sim, _, frame = te.make_multi_step(return_frame=True)(sim, np.float32([G]))
    field, ov = tr.field_from_frame(sim, frame)
    _, w_len, _ = tmw.pixel_windows(frame.T, tr.c_first, tr.c_last, tr.has_q,
                                    cap, te.cfg.n_cells)
    assert int(ov) == int((w_len - cap).clamp_min(0).sum()) > 0
    Tj = jnp.asarray(frame.T.numpy())
    _, jflen, jov = jmw.pixel_windows(Tj, jr.blk_c_first, jr.blk_c_last,
                                      jr.blk_has_q, cap, je.spec.L + cap,
                                      je.cfg.n_cells)
    # JAX's dual-plane fetch adds each start's offset in its 64-lane plane
    # to the fetched length; without it the windows and the count are JAX's
    jstart = np.where(np.asarray(jr.blk_has_q), np.asarray(Tj[jr.blk_c_first, 0]), 0)
    jw_len = np.asarray(jflen) - jstart % 64
    np.testing.assert_array_equal(jw_len, w_len.numpy())
    assert int(np.maximum(jw_len - cap, 0).sum()) == int(ov) <= int(jov)
    grid, idx = frame.start_grid.numpy(), tr.reuse_span_idx.numpy()
    pk = sim.packed.numpy().astype(np.float64)
    q = tr.q_packed.numpy().astype(np.float64)
    lanes = np.array([len(_span_rows(grid, idx[b])) for b in range(len(idx))])
    assert (lanes > cap).any() and (lanes <= w_len.numpy()).all()
    out = np.zeros(len(q))
    for b in np.nonzero(lanes)[0]:
        r = pk[_span_rows(grid, idx[b])[:cap]]
        r = r[r[:, 4] > 0]
        for i in range(b * 8, b * 8 + 8):
            d = np.sqrt((q[i, 0] - r[:, 0]) ** 2 + (q[i, 1] - r[:, 1]) ** 2) / te.cfg.h
            out[i] = (np.maximum(1 - 0.5 * d, 0) ** 4 * (1 + 2 * d)).sum()
    want = out[tr.unsort.numpy()] * tr.field_scale
    np.testing.assert_allclose(field.numpy(), want, atol=5e-5)
    full, ov_full = tr0.field_from_frame(sim, frame)
    assert int(ov_full) == 0 and float((full - field).abs().max()) > 0.1
    # the self-relayout mode counts its fluid lanes beyond the cap
    assert int(tr0.field(sim)[1]) == 0
    tr.spec = tr.spec._replace(cap=cap)
    assert int(tr.field(sim)[1]) > 0


def test_garbage_start_grid_and_index_pairs_are_clamped(drop):
    """Start-grid entries and index pairs that point anywhere are cut to the
    arrays they index, as the kernel cuts them: every lane names a source
    row and the field stays finite."""
    te, tr = drop[1], drop[4]
    pk, ctx, _ = te._relayout(te._initial_packed(T.build_drop_scene(te.cfg, "cpu")[0]))
    grid, idx = ctx.start_grid.clone(), tr.reuse_span_idx.clone()
    live = torch.nonzero((grid[idx[:, :, 1].long()] - grid[idx[:, :, 0].long()]) > 0)
    assert len(live) > 8
    for k, (lo, hi) in enumerate([(-7, 5), (1 << 30, 4), (3, 1 << 30), (-(1 << 31), (1 << 31) - 1)]):
        b, sp = live[2 * k].tolist()
        grid[idx[b, sp, 0]], grid[idx[b, sp, 1]] = lo, hi
    idx[live[-1][0], live[-1][1]] = torch.tensor([-3, 1 << 30], dtype=torch.int32)
    rows_idx, valid = twk._lanes(*twk._grid_spans(idx, grid, pk.shape[0]),
                                 tr.reuse_spec.cap)
    assert int(rows_idx.min()) >= 0 and int(rows_idx.max()) < pk.shape[0]
    assert valid.any()
    out = tmw.field_window(tr.q_packed, pk, grid, idx, tr.cfg, tr.reuse_spec)
    assert torch.isfinite(out).all() and float(out.max()) > 0
