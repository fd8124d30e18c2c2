"""The port's WindowEngine against the C reference's 3021-particle drop
(tests/fixtures/golden_drop_3k.npz, R = 0.0226) through all 2000 steps,
gated at steps 500, 1000 and 2000 with the JAX package's gates
(test_parity_3k.py:107-146: 3e-6, 1e-5 and 5e-5 m; 5e-4, 5e-4 and 2e-3
m/s; rho rtol 3e-4; overflow 0), through the kernels' plain versions on
the CPU.  cap=384 as in the JAX engine's gate.  test_torch_parity_3k.py
keeps the step-500 gate in a file of its own."""

import pathlib

import numpy as np
import torch

import pi_sph_fluid_tpu_torch as T

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_drop_3k.npz"
GATES = {500: (3e-6, 5e-4), 1000: (1e-5, 5e-4), 2000: (5e-5, 2e-3)}


def test_window_engine_parity_at_3k_through_step_2000():
    golden = np.load(FIXTURE)
    cfg = T.SPHConfig(r=0.0226)
    fluid, braw = T.build_drop_scene(cfg, "cpu")
    assert fluid.n == int(golden["n_fluid"]) == 3021
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, "cpu", cap=384)
    sim = eng.prime(fluid, (0.0, -9.81))
    multi = eng.make_multi_step()
    g100 = np.tile(np.float32([0.0, -9.81]), (100, 1))
    for k in range(1, 21):
        sim, st = multi(sim, g100)
        assert int(st.neighbor_overflow.max()) == 0, k * 100
        if k * 100 not in GATES:
            continue
        pos_tol, vel_tol = GATES[k * 100]
        assert int(golden["steps"][k]) == k * 100
        gs = golden["states"][k]
        ours = eng.unpad(sim)
        np.testing.assert_allclose(ours.x.numpy(), gs[:, 0], atol=pos_tol)
        np.testing.assert_allclose(ours.y.numpy(), gs[:, 1], atol=pos_tol)
        np.testing.assert_allclose(ours.u.numpy(), gs[:, 2], atol=vel_tol)
        np.testing.assert_allclose(ours.v.numpy(), gs[:, 3], atol=vel_tol)
        np.testing.assert_allclose(ours.rho.numpy(), gs[:, 5], rtol=3e-4)
