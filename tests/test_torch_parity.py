"""The port's WindowEngine vs the C reference's 269-particle drop
(tests/fixtures/golden_drop.npz), at the JAX package's gates
(test_parity.py:71-97), through the kernels' plain versions on the CPU."""

import pathlib

import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu_torch as T

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_drop.npz"
G = (0.0, -9.81)


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def trajectory():
    """States by id at steps 0, 100, 200 and 500."""
    cfg = T.SPHConfig()
    fluid, braw = T.build_drop_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, "cpu", tq=32, qb=8)
    sim = eng.prime(fluid, G)
    multi = eng.make_multi_step()
    out = {0: eng.unpad(sim)}
    step = 0
    for stop in (100, 200, 500):
        sim, st = multi(sim, np.tile(np.float32(G), (stop - step, 1)))
        assert int(st.neighbor_overflow.max()) == 0
        step = stop
        out[step] = eng.unpad(sim)
    return {k: {f: t.numpy() for f, t in zip(T.FluidState._fields, v)}
            for k, v in out.items()}


def test_scene_bitwise(golden):
    fluid, _ = T.build_drop_scene(T.SPHConfig(), "cpu")
    gs = golden["states"][0]
    np.testing.assert_array_equal(fluid.x.numpy(), gs[:, 0])
    np.testing.assert_array_equal(fluid.y.numpy(), gs[:, 1])
    np.testing.assert_array_equal(fluid.m.numpy(), gs[:, 4])


def test_primed_density_and_pressure(golden, trajectory):
    gs = golden["states"][0]
    np.testing.assert_allclose(trajectory[0]["rho"], gs[:, 5], rtol=3e-6)
    np.testing.assert_allclose(trajectory[0]["p"], gs[:, 6], rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("step,pos_tol,vel_tol", [
    (100, 5e-6, 5e-5),
    (200, 1e-5, 1e-4),
    (500, 1e-4, 5e-3),
])
def test_trajectory_parity(golden, trajectory, step, pos_tol, vel_tol):
    dump = step // 10
    assert int(golden["steps"][dump]) == step
    gs = golden["states"][dump]
    ours = trajectory[step]
    np.testing.assert_allclose(ours["x"], gs[:, 0], atol=pos_tol)
    np.testing.assert_allclose(ours["y"], gs[:, 1], atol=pos_tol)
    np.testing.assert_allclose(ours["u"], gs[:, 2], atol=vel_tol)
    np.testing.assert_allclose(ours["v"], gs[:, 3], atol=vel_tol)


def test_density_parity_at_500(golden, trajectory):
    np.testing.assert_allclose(trajectory[500]["rho"], golden["states"][50][:, 5],
                               rtol=1e-4)
