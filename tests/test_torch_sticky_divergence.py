"""How far a sticky layout takes the port's WindowEngine from the exact
path, on the CPU (the kernels' plain versions).

(a) The 269 drop from one primed state at resort_every 8 and 64 against
resort_every 1, by id, at ticks 128, 256 and 512, within the gates that
hold the port against the C reference (test_torch_parity.py): 1e-5 m and
1e-4 m/s through tick 256, 1e-4 m and 5e-3 m/s at 512.  A sticky layout
may differ from the exact path by no more than the port may differ from C.

(b) The 400-particle dam break at resort_every 64 for 8 groups: at the end
of each group, the stalest tick, the state's density against the jnp
oracle's (models/simulation.prime, fresh dense neighbour lists) on the same
positions, within 2e-6 relative.  This is the direct certificate that the
sticky layout lost no pair: one pair lost 0.3*H inside the support moves a
density by roughly 1e-4 to 1e-3.
"""

import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch.models import simulation

torch.set_num_threads(1)

G = (0.0, -9.81)
KW = dict(tq=32, qb=8)
CHECKS = (128, 256, 512)
# (|dx|, |dy| m; |du|, |dv| m/s) against resort_every=1 at each check
GATES = {128: (1e-5, 1e-4), 256: (1e-5, 1e-4), 512: (1e-4, 5e-3)}
DAM_PERIOD, DAM_GROUPS, RHO_REL = 64, 8, 2e-6


def _g(n: int) -> np.ndarray:
    return np.tile(np.float32(G), (n, 1))


def _by_id(eng, sim) -> dict:
    return {f: t.numpy() for f, t in zip(T.FluidState._fields, eng.unpad(sim))}


def _run(eng, sim, k: int) -> tuple:
    """States by id at each check, and the summed stale and largest
    overflow over the run."""
    multi = eng.make_multi_step(resort_every=k)
    out, stale, overflow, tick = {}, 0, 0, 0
    for stop in CHECKS:
        sim, st = multi(sim, _g(stop - tick))
        tick = stop
        out[stop] = _by_id(eng, sim)
        stale += 0 if st.stale is None else int(st.stale.sum())
        overflow = max(overflow, int(st.neighbor_overflow.max()))
    return out, stale, overflow


@pytest.fixture(scope="module")
def drop():
    cfg = T.SPHConfig()
    fluid, braw = T.build_drop_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, "cpu", **KW)
    sim = eng.prime(fluid, G)
    exact, _, overflow = _run(eng, sim, 1)
    assert overflow == 0
    return eng, sim, exact


@pytest.mark.parametrize("period", [8, 64])
def test_sticky_drop_stays_within_the_c_parity_gates(drop, period):
    eng, sim, exact = drop
    got, stale, overflow = _run(eng, sim, period)
    assert stale == 0 and overflow == 0, (stale, overflow)
    for tick, (pos_tol, vel_tol) in GATES.items():
        a, b = exact[tick], got[tick]
        pos = max(np.abs(b[f] - a[f]).max() for f in "xy")
        vel = max(np.abs(b[f] - a[f]).max() for f in "uv")
        print(f"drop r{period} vs r1 at tick {tick}: |dpos| {pos:.3g} m, "
              f"|dvel| {vel:.3g} m/s")
        assert pos <= pos_tol and vel <= vel_tol, (period, tick, pos, vel)


def test_stalest_tick_density_equals_the_fresh_oracle():
    cfg = T.SPHConfig()
    fluid, braw = T.build_dam_break_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, "cpu", **KW)
    sim = eng.prime(fluid, G)
    multi = eng.make_multi_step(resort_every=DAM_PERIOD)
    for group in range(DAM_GROUPS):
        sim, st = multi(sim, _g(DAM_PERIOD))
        assert int(st.stale.sum()) == 0 and int(st.neighbor_overflow.max()) == 0, group
        fl = eng.unpad(sim)
        ref = simulation.prime(fl, b, bg, G, cfg)
        rho_ref = ref.fluid.rho[torch.argsort(ref.ids.long())]
        rel = float(((fl.rho - rho_ref).abs() / rho_ref).max())
        print(f"dam r{DAM_PERIOD} group {group}: rho rel to the oracle {rel:.3g}")
        assert rel <= RHO_REL, (group, rel)
