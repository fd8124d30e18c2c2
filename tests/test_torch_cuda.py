"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Skips without a card.  This file imports no JAX, so on the GPU machine it
runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pi_sph_fluid_tpu_torch.ops.window import window_kernels as wk
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
