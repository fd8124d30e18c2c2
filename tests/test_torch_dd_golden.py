"""The port's WindowDomain on 4 slabs against the C reference's
3021-particle drop (tests/fixtures/golden_drop_3k.npz, R = 0.0226) at step
200, at the JAX package's DD gate (test_parity_3k.py:149-191: 5e-5 m,
3e-3 m/s, rho rtol 1e-3, overflow 0, n_valid whole), through the kernels'
plain versions on the CPU.  The gate gates the decomposition itself,
migration, halo exchange, per-slab relayout and ghost densities, against the
C trajectory, not by way of the single engine."""

import pathlib

import numpy as np
import torch

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch.parallel import LocalComm, WindowDomain

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_drop_3k.npz"


def test_dd_parity_at_3k_step_200():
    golden = np.load(FIXTURE)
    cfg = T.SPHConfig(r=0.0226)
    fluid, braw = T.build_drop_scene(cfg, "cpu")
    assert fluid.n == int(golden["n_fluid"]) == 3021
    b, bg = T.prepare_boundary(braw, cfg)
    dd = WindowDomain(cfg, b, bg, fluid.n, LocalComm(4), "cpu")
    state = dd.init(fluid)
    multi = dd.make_multi_step()
    g100 = np.tile(np.float32([0.0, -9.81]), (100, 1))
    for _ in range(2):
        state, st = multi(state, g100)
        assert int(st["overflow"].max()) == 0
        assert int(st["n_valid"][-1]) == fluid.n
    assert int(golden["steps"][2]) == 200
    gs = golden["states"][2]
    ours = dd.gather(state)
    np.testing.assert_allclose(ours.x.numpy(), gs[:, 0], atol=5e-5)
    np.testing.assert_allclose(ours.y.numpy(), gs[:, 1], atol=5e-5)
    np.testing.assert_allclose(ours.u.numpy(), gs[:, 2], atol=3e-3)
    np.testing.assert_allclose(ours.v.numpy(), gs[:, 3], atol=3e-3)
    np.testing.assert_allclose(ours.rho.numpy(), gs[:, 5], rtol=1e-3)
