"""The port's per-slab renderer (WindowDomain.make_render,
pi_sph_fluid_tpu_torch/parallel/domain_window.py) on the CPU, where the
field kernel's wrapper runs its plain version: the frame against the
port's oracle renderer on the gathered state and against JAX's per-slab
renderer (interpret mode, on the 8 virtual CPU devices of
tests/conftest.py) on the same state, its overflow counts, and its static
pixel tables against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.models.scene import pixel_centers as j_pixel_centers
from pi_sph_fluid_tpu.parallel.domain_window import WindowDomain as JWindowDomain
from pi_sph_fluid_tpu.render.metaballs_window import INERT_PX as J_INERT_PX
from pi_sph_fluid_tpu.render.metaballs_window import pixel_layout as j_pixel_layout

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import convert
from pi_sph_fluid_tpu_torch.parallel import LocalComm, WindowDomain
from pi_sph_fluid_tpu_torch.parallel import domain_window
from pi_sph_fluid_tpu_torch.render.metaballs import make_renderer

torch.set_num_threads(1)

G = (0.0, -9.81)
KW = dict(tq=32, qb=8, cap=256, seg_q=2)
SHAPES = [(64, 128), (256, 128)]


@pytest.fixture(scope="module")
def scene():
    """The dam break at the default resolution (400 particles)."""
    cfg = J.SPHConfig()
    fluid, braw = J.build_dam_break_scene(cfg)
    b, bg = J.prepare_boundary(braw, cfg)
    return dict(cfg=cfg, fluid=fluid, b=b, bg=bg, tcfg=T.SPHConfig(),
                tb=convert.boundary_state(b, "cpu"), tbg=convert.grid_context(bg, "cpu"))


def _port(s, d, **kw):
    return WindowDomain(s["tcfg"], s["tb"], s["tbg"], s["fluid"].n, LocalComm(d), "cpu",
                        **dict(KW, **kw))


def _jax(s, d, **kw):
    mesh = Mesh(np.asarray(jax.devices()[:d]), ("x",))
    return JWindowDomain(s["cfg"], s["b"], s["bg"], s["fluid"].n, mesh, planes=1,
                         band=0, interpret=True, **dict(KW, **kw))


@pytest.fixture(scope="module")
def state(scene):
    """``state(d, **caps)`` -> (JAX domain, its state after 6 ticks at
    resort_every=2 from init, the port's domain, the same state converted),
    built once a configuration."""
    built = {}

    def get(d, **kw):
        key = (d, tuple(sorted(kw.items())))
        if key not in built:
            jd = _jax(scene, d, **kw)
            js, _ = jax.jit(jd.make_multi_step(resort_every=2))(
                jd.init(scene["fluid"]), jnp.asarray(np.tile(np.float32(G), (6, 1))))
            built[key] = (jd, js, _port(scene, d, **kw), convert.domain_state(js, "cpu"))
        return built[key]

    return get


def _img(fb, rows, cols):
    return T.unpack_framebuffer(np.asarray(fb), rows, cols)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("rows,cols", SHAPES)
def test_dd_frame_matches_oracle_and_jax(scene, state, d, rows, cols):
    """test_parallel_window.py:206-234: the d-slab frame equals the port's
    oracle renderer (make_renderer) on the gathered state, and JAX's
    per-slab frame on the same state, pixel for pixel; no overflow; the
    dam is lit."""
    jd, js, td, ts = state(d)
    fb, ov = td.make_render(rows, cols)(ts)
    assert fb.shape == (rows // 8 * cols,) and fb.dtype == torch.uint8
    ref = make_renderer(scene["tcfg"], rows, cols)(td.gather(ts))
    jfb, jov = jax.jit(jd.make_render(rows, cols))(js)
    img = _img(fb, rows, cols)
    assert img.any() and not img.all()
    np.testing.assert_array_equal(img, _img(ref, rows, cols))
    np.testing.assert_array_equal(img, _img(jfb, rows, cols))
    assert int(ov) == int(jov) == 0


def test_halo_overflow_counted_as_jax_counts_it(state):
    """halo_cap=8 starves the render's [x, y, m] exchange: the frame's
    overflow counts the dropped ghosts, JAX's count exactly."""
    jd, js, td, ts = state(4, halo_cap=8)
    _, ov = td.make_render()(ts)
    _, jov = jax.jit(jd.make_render())(js)
    assert int(ov) > 0
    assert int(ov) == int(jov)


def test_pixel_window_overflow_counted(state, monkeypatch):
    """A pixel cap of 32 lanes truncates windows: the frame's overflow is
    the fluid lanes past the cap over every slab's pixel windows, resolved
    from the start grid each slab's sort gave its field kernel, and never
    silent."""
    _, _, td, ts = state(2)
    monkeypatch.setattr(domain_window, "pixel_window_cap", lambda *a: 32)
    seen, field_window = [], domain_window.field_window

    def spy(q, rows, grid, idx, cfg, spec):
        seen.append((grid, idx, spec.cap))
        return field_window(q, rows, grid, idx, cfg, spec)

    monkeypatch.setattr(domain_window, "field_window", spy)
    _, ov = td.make_render()(ts)
    assert len(seen) == 2 and all(cap == 32 for _, _, cap in seen)
    want = sum(int(torch.clamp_min((grid[idx[:, :, 1]] - grid[idx[:, :, 0]]).sum(1) - 32,
                                   0).sum()) for grid, idx, _ in seen)
    assert want > 0 and int(ov) == want


@pytest.mark.parametrize("d", [2, 4])
def test_pixel_tables_equal_jax(scene, d):
    """The static per-slab pixel layout (`domain_window.py:773-799`): each
    pixel's slab, the padded queries and block cells, and the unsort table
    into the gathered field, bitwise what JAX's make_render builds."""
    td = _port(scene, d)
    cfg, lcfg = scene["cfg"], td.lcfg
    rows, cols, qb, tq = 64, 128, 8, 64
    tab = td._pixel_tables(rows, cols, qb, tq)
    # JAX's own lines, on its own functions
    jlcfg = cfg.replace(width=(td.local_cols - 0.5) * cfg.cell_length)
    k, cell = td.k_cols, np.float32(cfg.cell_length)
    px, py = j_pixel_centers(cfg, rows, cols)
    dest = np.clip(np.clip((px / cell).astype(np.int64), 0, cfg.n_cell_cols - 1) // k,
                   0, d - 1)
    lays = []
    for dev in range(d):
        sel = np.nonzero(dest == dev)[0]
        shift = np.float32(dev * k - 3) * cell
        lays.append((sel, j_pixel_layout(jlcfg, (px[sel] - shift).astype(np.float32),
                                          py[sel].astype(np.float32), qb, tq)))
    n_layout = max(lay["n_layout"] for _, lay in lays)
    assert tab["n_layout"] == n_layout
    unsort = np.zeros(rows * cols, np.int64)
    for dev, (sel, lay) in enumerate(lays):
        nl, nb = lay["n_layout"], lay["n_layout"] // qb
        np.testing.assert_array_equal(tab["q"][dev, :nl], np.asarray(lay["q"]))
        assert (tab["q"][dev, nl:, 0:2] == J_INERT_PX).all()
        assert (tab["q"][dev, nl:, 2:] == 0).all()
        np.testing.assert_array_equal(tab["c_first"][dev, :nb], np.asarray(lay["c_first"]))
        np.testing.assert_array_equal(tab["c_last"][dev, :nb], np.asarray(lay["c_last"]))
        np.testing.assert_array_equal(tab["has_q"][dev, :nb], np.asarray(lay["has_q"]))
        assert not tab["has_q"][dev, nb:].any()
        assert (tab["c_first"][dev, nb:] == lcfg.n_cells).all()
        unsort[sel] = dev * n_layout + np.asarray(lay["slots"])
    np.testing.assert_array_equal(tab["unsort"], unsort)
    assert len(set(tab["unsort"].tolist())) == rows * cols
