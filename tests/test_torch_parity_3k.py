"""The port's WindowEngine vs the C reference's 3021-particle drop
(tests/fixtures/golden_drop_3k.npz, R = 0.0226) to step 500, at the JAX
package's step-500 gate (test_parity_3k.py:129: 3e-6 m, 5e-4 m/s, rho
rtol 3e-4), through the kernels' plain versions on the CPU.  cap=384 as
in the JAX engine's 3k gate: the default 256 overflows late in this fall.
The full 2000 steps run on the GPU in chip_smoke.py."""

import pathlib

import numpy as np
import torch

import pi_sph_fluid_tpu_torch as T

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_drop_3k.npz"


def test_window_engine_parity_at_3k_step_500():
    golden = np.load(FIXTURE)
    cfg = T.SPHConfig(r=0.0226)
    fluid, braw = T.build_drop_scene(cfg, "cpu")
    assert fluid.n == int(golden["n_fluid"]) == 3021
    np.testing.assert_array_equal(fluid.x.numpy(), golden["states"][0][:, 0])
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, "cpu", cap=384)
    sim = eng.prime(fluid, (0.0, -9.81))
    np.testing.assert_allclose(eng.unpad(sim).rho.numpy(), golden["states"][0][:, 5],
                               rtol=3e-6)
    sim, st = eng.make_multi_step()(sim, np.tile(np.float32([0.0, -9.81]), (500, 1)))
    assert int(st.neighbor_overflow.max()) == 0
    assert int(golden["steps"][5]) == 500
    gs = golden["states"][5]
    ours = eng.unpad(sim)
    np.testing.assert_allclose(ours.x.numpy(), gs[:, 0], atol=3e-6)
    np.testing.assert_allclose(ours.y.numpy(), gs[:, 1], atol=3e-6)
    np.testing.assert_allclose(ours.u.numpy(), gs[:, 2], atol=5e-4)
    np.testing.assert_allclose(ours.v.numpy(), gs[:, 3], atol=5e-4)
    np.testing.assert_allclose(ours.rho.numpy(), gs[:, 5], rtol=3e-4)
