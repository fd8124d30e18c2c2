"""A full dam-break collapse through the port's oracle slab decomposition
on 8 slabs (test_parallel.py:111-144): 500 steps of sustained migration and
halo traffic, with every particle present exactly once, no overflow, and
speeds past 1 m/s, so the collapse really happened."""

import numpy as np
import torch

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch.parallel import DomainDecomposition, LocalComm

torch.set_num_threads(1)


def test_500_step_collapse_8_slabs():
    cfg = T.SPHConfig()
    fluid, braw = T.build_dam_break_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    dd = DomainDecomposition(cfg, b, bg, fluid.n, LocalComm(8), "cpu")
    state = dd.init(fluid)
    step = dd.make_step()
    worst_ov, speed = 0, 0.0
    for k in range(500):
        state, st = step(state, (0.0, -9.81))
        if k % 100 == 99:
            worst_ov = max(worst_ov, int(st["overflow"]))
            assert int(st["n_valid"]) == fluid.n
            speed = float(st["max_speed"])
    assert worst_ov == 0
    assert speed > 1.0
    assert torch.isfinite(state.fluid.x).all()
    ids = state.ids.numpy()
    np.testing.assert_array_equal(np.sort(ids[ids >= 0]), np.arange(fluid.n))
