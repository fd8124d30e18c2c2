"""The sequence of the port's multi-process worker (pi_sph_fluid_tpu_torch/
tools/multihost_worker.py: one exact step, 8 sticky ticks at resort_every=2,
one 64x128 per-slab frame, the export) run in one process over 8 slabs,
against JAX's 8-device WindowDomain (interpret mode, exact-start windows,
on the virtual CPU devices of tests/conftest.py) on the same dam: the
single-process reference of tests/test_multihost.py:73-108, held at JAX's
DD gates (tests/test_parallel_window.py:60-64)."""

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
from pi_sph_fluid_tpu_torch.tools import multihost_worker

torch.set_num_threads(1)

D = 8
KW = dict(tq=32, qb=8, cap=256, seg_q=2)


@pytest.fixture(scope="module")
def runs():
    cfg = J.SPHConfig()
    fluid, braw = J.build_dam_break_scene(cfg)
    b, bg = J.prepare_boundary(braw, cfg)

    mesh = Mesh(np.asarray(jax.devices()[:D]), ("x",))
    jd = JWindowDomain(cfg, b, bg, fluid.n, mesh, planes=1, band=0, interpret=True, **KW)
    g = jnp.asarray((0.0, -9.81), jnp.float32)
    state, _ = jax.jit(jd.make_step())(jd.init(fluid), g)
    state, _ = jax.jit(jd.make_multi_step(resort_every=2))(state, jnp.broadcast_to(g, (8, 2)))
    jfb, _ = jax.jit(jd.make_render(*multihost_worker.FRAME))(state)
    jfl = jd.export(state)[0]

    td = WindowDomain(T.SPHConfig(), convert.boundary_state(b, "cpu"),
                      convert.grid_context(bg, "cpu"), fluid.n, LocalComm(D), "cpu", **KW)
    res = multihost_worker.run(td, convert.fluid_state(fluid, "cpu"))
    return res, jfl, np.asarray(jfb)


def test_eight_slabs_match_jax_window_domain(runs):
    """Positions within 1e-6 m, velocities within 1e-5 m/s of JAX's, rho
    within rtol 1e-5, and the frame pixel-equal.  On the CPU the
    positions came bitwise equal to JAX's (max |dx| 0.0), as at 4 slabs."""
    res, jfl, jfb = runs
    fl = res.export[0]
    assert fl.n == jfl.x.shape[0]
    for f, tol in (("x", 1e-6), ("y", 1e-6), ("u", 1e-5), ("v", 1e-5)):
        np.testing.assert_allclose(getattr(fl, f).numpy(), np.asarray(getattr(jfl, f)),
                                   atol=tol, rtol=0, err_msg=f)
    np.testing.assert_allclose(fl.rho.numpy(), np.asarray(jfl.rho), rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(T.unpack_framebuffer(res.fb),
                                  T.unpack_framebuffer(jfb))
