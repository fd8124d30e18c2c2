"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Skips without a card.  This file imports no JAX, so on the GPU machine it
runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pi_sph_fluid_tpu_torch.ops.window import window_kernels as wk
from pi_sph_fluid_tpu_torch.render import metaballs_window as mw
from pi_sph_fluid_tpu_torch.tools import span_dma_probe as sp
from pi_sph_fluid_tpu_torch.tools import unaligned_probe as up
from pi_sph_fluid_tpu_torch.utils.profiling import pool_engine

G = (0.0, -9.81)


@pytest.fixture
def pool_frame():
    """One relayout of a 20k pool with seeded random velocities, so that
    the viscosity term is live."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    eng, fluid = pool_engine(20_000, "cuda")
    rng = np.random.default_rng(3)
    fluid = fluid._replace(**{
        k: torch.from_numpy(rng.normal(0.0, 0.5, fluid.n).astype(np.float32)).cuda()
        for k in ("u", "v")})
    pk, ctx, ov = eng._relayout(eng._initial_packed(fluid))
    assert int(ov) == 0
    trip = ctx.trip_src.long()
    geo_d = torch.cat([torch.cat([pk[:, [0, 1, 4]], torch.zeros_like(pk[:, :1])], 1),
                       eng._tail_d]).index_select(0, trip)
    return eng, pk, ctx, trip, geo_d


@pytest.mark.cuda
def test_density_kernel_matches_plain(pool_frame):
    """rho rtol 1e-6 (FMA contraction and another summation order); the
    copied geo8 columns bitwise."""
    eng, pk, ctx, _, geo_d = pool_frame
    args = (pk, geo_d, ctx.w_start, ctx.flen, eng.cfg, eng.spec)
    before = wk.density_window.launches
    g8k, rpk = wk.density_window(*args)
    g8p, rpp = wk.density_window_plain(*args)
    torch.cuda.synchronize()
    assert wk.density_window.launches == before + 1
    torch.testing.assert_close(rpk[:, 0], rpp[:, 0], rtol=1e-6, atol=0)
    assert torch.equal(g8k[:, [0, 1, 2, 3, 4, 7]], g8p[:, [0, 1, 2, 3, 4, 7]])


@pytest.mark.cuda
@pytest.mark.parametrize("half_dt_frac,damp", [(0.5, 0.97), (0.0, 1.0)])
def test_forces_kernel_matches_plain(pool_frame, half_dt_frac, damp):
    """acc rtol 2e-5 / atol 2e-4, as the module gates; u' and v' within
    half_dt times that bound plus 2 ulp; the copied pk_next columns
    bitwise; the priming pass (half_dt = 0, damp = 1) leaves u and v
    bitwise unchanged."""
    eng, pk, ctx, trip, geo_d = pool_frame
    g8, rp = wk.density_window_plain(pk, geo_d, ctx.w_start, ctx.flen,
                                     eng.cfg, eng.spec)
    geo_f = torch.cat([g8, eng._tail_f]).index_select(0, trip)
    half_dt = float(np.float32(half_dt_frac * eng.cfg.dt))
    args = (pk, g8, rp, geo_f, ctx.w_start, ctx.flen, G, eng.cfg, eng.spec,
            half_dt, damp)
    pkk, acck = wk.forces_window(*args)
    pkp, accp = wk.forces_window_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(acck, accp, rtol=2e-5, atol=2e-4)
    bound = (half_dt * (2e-4 + 2e-5 * accp.abs())
             + 2 * torch.finfo(torch.float32).eps * pkp[:, 2:4].abs())
    assert bool(((pkk[:, 2:4] - pkp[:, 2:4]).abs() <= bound).all())
    assert torch.equal(pkk[:, [0, 1, 4, 5, 6, 7]], pkp[:, [0, 1, 4, 5, 6, 7]])
    if half_dt_frac == 0.0:
        assert torch.equal(pkk[:, 2:4], pk[:, 2:4])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 256])
def test_field_kernel_matches_plain(rows):
    """The field kernel against its plain version on the 20k pool's frame
    (random velocities, one exact tick), through the renderer's own inputs:
    the scaled field within rtol 1e-5 / atol 5e-5 (test_render_window.py:60), lit
    pixels identical wherever |field - 1| > 1e-3, one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    eng, fluid = pool_engine(20_000, "cuda")
    rng = np.random.default_rng(3)
    fluid = fluid._replace(**{
        k: torch.from_numpy(rng.normal(0.0, 0.5, fluid.n).astype(np.float32)).cuda()
        for k in ("u", "v")})
    sim, st, frame = eng.make_multi_step(return_frame=True)(
        eng.prime(fluid, G), np.float32([G]))
    rend = mw.WindowRenderer(eng, rows, 128)
    geo, ws, wl, ov = rend.frame_inputs(sim, frame)
    assert int(ov) == 0
    args = (rend.q_packed, geo, ws, wl, eng.cfg, rend.reuse_spec)
    before = mw.field_window.launches
    fk = mw.field_window(*args)
    fp = mw.field_window_plain(*args)
    torch.cuda.synchronize()
    assert mw.field_window.launches == before + 1
    fk, fp = fk * rend.field_scale, fp * rend.field_scale
    torch.testing.assert_close(fk, fp, rtol=1e-5, atol=5e-5)
    confident = (fp - 1.0).abs() > 1e-3
    assert torch.equal((fk >= 1.0)[confident], (fp >= 1.0)[confident])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["aligned", "unaligned", "broken_promise"])
def test_window_copy_kernel_matches_plain(form):
    """Bitwise, from 128-aligned starts (16-byte loads), from odd starts
    (4-byte loads), and from odd starts under the aligned promise (the
    kernel's 4-byte fallback); an L that is not a multiple of 4 included;
    one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    for L, n_tiles in ((1 << 14, 16), ((1 << 14) + 3, 5)):
        src, al, un = up.make_starts(L, n_tiles, seed=1)
        starts = torch.from_numpy(al if form == "aligned" else un).cuda()
        src = torch.from_numpy(src).cuda()
        before = up.window_copy.launches
        got = up.window_copy(starts, src, aligned=form != "unaligned")
        want = up.window_copy_plain(starts, src)
        torch.cuda.synchronize()
        assert up.window_copy.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(sp.VARIANTS))
def test_span_density_kernel_matches_plain(variant):
    """Within rtol 1e-5 of max |out| (another summation order, and nvcc's
    FMA contraction); one launch counted; w_s rows past n_tiles unread."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    spans, span_cap = sp.VARIANTS[variant]
    q, src, w_s = sp.make_inputs(8192, 20_000, spans, span_cap, "cuda", seed=2)
    w_s = torch.cat([w_s, torch.full_like(w_s[:8], -(1 << 30))])
    before = sp.span_density.launches
    got = sp.span_density(q, src, w_s, spans, span_cap)
    want = sp.span_density_plain(q, src, w_s, spans, span_cap)
    torch.cuda.synchronize()
    assert sp.span_density.launches == before + 1
    scale = float(want.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
