"""The plain reference against the port's plain path (the CPU versions of
its kernels) on a 348-particle tank and on the upstream 269-particle
drop: the wall pseudo-masses, the primed state, 8 ticks exact and sticky,
and one frame."""

import json

import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu_torch as sph
from benchmark import check, harness
from benchmark.reference import Physics, Reference
from benchmark.scene import build_scene
from conftest import ROOT

# float32 agreement.  psi and the primed density are a few ulps apart.  In
# the pressurised tank the Tait EOS turns a density ulp into c^2 * ulp / R
# of acceleration, ~0.05 g at R = 0.125 m; the falling drop has no pressure.
TOL = {
    "tank": dict(psi=1e-6, prime_rho=2e-6, prime_acc=0.2, pos=1e-4, vel=5e-3, rho=5e-5, frame=0),
    "drop": dict(psi=1e-6, prime_rho=2e-6, prime_acc=1e-4, pos=1e-4, vel=1e-4, rho=5e-6, frame=0),
}


def _config(name):
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("scene", ["tank", "drop"])
@pytest.mark.parametrize("resort", [1, 4])
def test_reference_matches_port(scene, resort):
    cfg = _config("tank_1m" if scene == "tank" else "drop_269")
    if scene == "tank":
        cfg.update(r=0.125)
    s = build_scene(cfg, 77)
    pcfg, phys = harness.port_config(cfg), Physics(cfg)
    fluid, walls = harness._inputs(cfg, s, pcfg, torch.device("cpu"))
    assert fluid.n == (348 if scene == "tank" else 269)
    b, bg = sph.prepare_boundary(walls, pcfg)
    eng = sph.WindowEngine(pcfg, b, bg, fluid.n, "cpu", tq=32, qb=8)
    sim = eng.prime(fluid, (0.0, -9.81))
    g = np.tile(np.float32([0.0, -9.81]), (8, 1))
    out, st, frame = eng.make_multi_step(resort_every=resort, return_frame=True)(sim, g)
    fb, overflow = sph.WindowRenderer(eng, 64, 128).render_from_frame(out, frame)
    assert int(st.neighbor_overflow.sum()) == 0 and int(overflow) == 0

    ref = Reference(phys, s["wall_x"], s["wall_y"], "cpu")
    got = check.start_numbers(ref, (s["fluid_x"], s["fluid_y"]), (0.0, -9.81),
                              harness.program_rows(sim), (b.x, b.y, b.m))
    ref_out, ref_fb = check.reference_outputs(ref, harness.program_rows(sim), g, (64, 128))
    got.update(check.dispatch_numbers(harness.program_rows(sim), harness.program_rows(out), fb,
                                      ref_out, ref_fb, phys))
    assert int(torch.count_nonzero(ref_fb)) > 0
    for k, tol in TOL[scene].items():
        assert got[k] <= tol, (k, got[k], tol)
