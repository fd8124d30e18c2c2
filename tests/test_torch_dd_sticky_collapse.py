"""The long run of the port's sticky slab decomposition on the CPU
(test_parallel_window.py:102-145): a whole dam-break collapse across 8
slabs at resort_every=4, with migration and halo traffic through about 130
group layouts.  Its own file: it is the slowest DD test."""

import numpy as np
import torch

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch.parallel import LocalComm, WindowDomain

torch.set_num_threads(1)

G = (0.0, -9.81)
KW = dict(tq=32, qb=8, cap=256, seg_q=2)


def test_500_step_collapse_8_slabs_sticky():
    """Step 24 against the port's single engine in the same sticky mode
    (primed, accelerations zeroed, as the domain starts) within 1e-5 m and
    1e-4 m/s; then 500 steps in dispatches of 100 with n_valid whole on
    every group's last tick, overflow 0, a real collapse (max speed above 1
    m/s), a finite state and every id present once."""
    cfg = T.SPHConfig()
    fluid, braw = T.build_dam_break_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    dd = WindowDomain(cfg, b, bg, fluid.n, LocalComm(8), "cpu", **KW)
    multi4 = dd.make_multi_step(resort_every=4)
    state, st = multi4(dd.init(fluid), np.tile(np.float32(G), (24, 1)))

    eng = T.WindowEngine(cfg, b, bg, fluid.n, "cpu", **KW)
    sim = eng.prime(fluid, G)
    sim = sim._replace(au=torch.zeros_like(sim.au), av=torch.zeros_like(sim.av))
    sim, _ = eng.make_multi_step(resort_every=4)(sim, np.tile(np.float32(G), (24, 1)))
    fd, fe = dd.gather(state), eng.unpad(sim)
    np.testing.assert_allclose(fd.x.numpy(), fe.x.numpy(), atol=1e-5)
    np.testing.assert_allclose(fd.y.numpy(), fe.y.numpy(), atol=1e-5)
    np.testing.assert_allclose(fd.u.numpy(), fe.u.numpy(), atol=1e-4)

    worst_ov = int(st["overflow"].max())
    max_speed = 0.0
    g100 = np.tile(np.float32(G), (100, 1))
    for _ in range(5):
        state, st = multi4(state, g100)
        worst_ov = max(worst_ov, int(st["overflow"].max()))
        assert (st["n_valid"][3::4] == fluid.n).all()
        max_speed = max(max_speed, float(st["max_speed"].max()))
    assert worst_ov == 0
    assert int(st["stale"].sum()) == 0
    assert max_speed > 1.0
    assert torch.isfinite(dd.gather(state).x).all()
    ids = torch.sort(state.ids[state.ids >= 0]).values
    assert torch.equal(ids, torch.arange(fluid.n, dtype=ids.dtype))
