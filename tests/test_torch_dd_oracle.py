"""The port's communication layer and oracle slab decomposition
(pi_sph_fluid_tpu_torch/parallel/comm.py, domain.py) on the CPU: against
the JAX package's DomainDecomposition on the 8 virtual CPU devices of
tests/conftest.py, and against the port's own oracle stepper, on the same
numpy inputs.  Tolerances are test_parallel.py's (x, y, u, v within 2e-5,
rho within rtol 1e-6): the pair passes are the same, only the sums of a
slab run over its own candidate order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.parallel.domain import DomainDecomposition as JDomain
from pi_sph_fluid_tpu.parallel.domain import _take_first as j_take_first

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import convert
from pi_sph_fluid_tpu_torch.models import simulation
from pi_sph_fluid_tpu_torch.parallel import DomainDecomposition, LocalComm
from pi_sph_fluid_tpu_torch.parallel.domain import _take_first

torch.set_num_threads(1)

G = (0.0, -9.81)
FIELDS = T.FluidState._fields
TOLS = (("x", 2e-5, 0), ("y", 2e-5, 0), ("u", 2e-5, 0), ("v", 2e-5, 0),
        ("rho", 0, 1e-6))


@pytest.fixture(scope="module")
def setup():
    """The dam break at r = 0.032 (2,401 particles), in both packages."""
    cfg = J.SPHConfig(r=0.032)
    fluid, braw = J.build_dam_break_scene(cfg)
    b, bg = J.prepare_boundary(braw, cfg)
    return dict(cfg=cfg, fluid=fluid, b=b, bg=bg, tcfg=T.SPHConfig(r=0.032),
                tfluid=convert.fluid_state(fluid, "cpu"),
                tb=convert.boundary_state(b, "cpu"),
                tbg=convert.grid_context(bg, "cpu"))


def _mesh(d):
    return Mesh(np.asarray(jax.devices()[:d]), ("x",))


def _domains(s, d, **kw):
    jd = JDomain(s["cfg"], s["b"], s["bg"], s["fluid"].n, _mesh(d), **kw)
    td = DomainDecomposition(s["tcfg"], s["tb"], s["tbg"], s["fluid"].n,
                             LocalComm(d), "cpu", **kw)
    return jd, td


def test_local_comm_shift_end_slabs_receive_zeros():
    comm = LocalComm(3)
    bufs = [torch.full((2, 3), float(i + 1)) for i in range(3)]
    right = comm.shift(bufs, +1)
    left = comm.shift(bufs, -1)
    assert [float(t[0, 0]) for t in right] == [0.0, 1.0, 2.0]
    assert [float(t[0, 0]) for t in left] == [2.0, 3.0, 0.0]
    assert right[0].shape == left[2].shape == (2, 3)
    assert float(right[0].abs().sum()) == float(left[2].abs().sum()) == 0.0
    counts = [torch.tensor([i, 10 * i], dtype=torch.int32) for i in range(3)]
    assert comm.all_sum(counts).tolist() == [3, 30]
    assert comm.all_sum(counts).dtype == torch.int32
    assert comm.all_max(counts).tolist() == [2, 20]
    with pytest.raises(ValueError):
        comm.shift(bufs[:2], +1)


@pytest.mark.parametrize("cap", [7, 40, 64], ids=["below", "equal", "above"])
@pytest.mark.parametrize("seed", [0, 1])
def test_take_first_matches_jax(cap, seed):
    """Random masks over 40 slots, float32 and int32 arrays: the packed
    arrays, the lane validity and the overflow bitwise JAX's, with cap
    below, equal to and above the source length."""
    rng = np.random.default_rng(seed)
    mask = rng.random(40) < 0.4
    f = rng.normal(size=(3, 40)).astype(np.float32)
    ids = rng.integers(0, 1000, 40).astype(np.int32)
    jp, jv, jov = j_take_first(jnp.asarray(mask),
                               [jnp.asarray(a) for a in f] + [jnp.asarray(ids)], cap)
    tp, tv, tov = _take_first(torch.from_numpy(mask),
                              [torch.from_numpy(a) for a in f] + [torch.from_numpy(ids)],
                              cap)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for a, b in zip(tp, jp):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tov) == int(jov) == max(int(mask.sum()) - cap, 0)


def test_take_first_pads_when_cap_exceeds_source():
    """test_parallel_window.py:237-251: a cap above the source length pads,
    it does not clamp to the source."""
    packed, lane_valid, ov = _take_first(torch.tensor([True, False, True, False]),
                                         [torch.tensor([1.0, 2.0, 3.0, 4.0])], cap=6)
    assert packed[0].shape == lane_valid.shape == (6,)
    np.testing.assert_array_equal(packed[0].numpy(), [1, 3, 0, 0, 0, 0])
    assert int(ov) == 0


@pytest.mark.parametrize("d", [4, 8])
def test_init_matches_jax_slab_by_slab(setup, d):
    """Capacities and every slab array of ``init`` bitwise JAX's; every
    particle lies in its slab's x range."""
    jd, td = _domains(setup, d)
    assert (td.slab_cap, td.halo_cap, td.mig_cap) == (jd.slab_cap, jd.halo_cap, jd.mig_cap)
    js, ts = jd.init(setup["fluid"]), td.init(setup["tfluid"])
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts.fluid, f).numpy(),
                                      np.asarray(getattr(js.fluid, f)), err_msg=f)
    for f in ("ids", "au", "av"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    x = ts.fluid.x.view(d, -1).numpy()
    valid = ts.fluid.m.view(d, -1).numpy() > 0
    for s in range(d):
        if valid[s].any():
            assert x[s][valid[s]].min() >= s * td.slab_w - 1e-6
            assert x[s][valid[s]].max() <= (s + 1) * td.slab_w + 1e-6
    assert valid.sum() == setup["fluid"].n


@pytest.mark.parametrize("d", [4, 8])
def test_sharded_step_matches_oracle(setup, d):
    """test_parallel.py:34-67: 10 steps of d slabs against 10 of the
    port's oracle stepper from the same zero-acceleration state."""
    _, td = _domains(setup, d)
    state = td.init(setup["tfluid"])
    step = td.make_step()
    f = setup["tfluid"]
    zero = torch.zeros_like(f.u)
    sim = simulation.SimState(fluid=f, ids=torch.arange(f.n, dtype=torch.int32),
                              au=zero, av=zero)
    ostep = simulation.make_step(setup["tcfg"], setup["tb"], setup["tbg"])
    for _ in range(10):
        state, st = step(state, G)
        sim, _ = ostep(sim, G)
    assert int(st["overflow"]) == 0
    assert int(st["n_valid"]) == f.n
    got = td.gather(state)
    inv = torch.argsort(sim.ids.long())
    for field, atol, rtol in TOLS:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   getattr(sim.fluid, field)[inv].numpy(),
                                   atol=atol, rtol=rtol, err_msg=f"{field} at d={d}")


@pytest.mark.parametrize("d", [4, 8])
def test_matches_jax_domain_decomposition(setup, d):
    """10 steps on d slabs beside JAX's DomainDecomposition from the same
    init: the ids of every slot and the counts bitwise, the fields within
    test_parallel.py's tolerances slot by slot, the stats within rtol 1e-6."""
    jd, td = _domains(setup, d)
    js = jd.init(setup["fluid"])
    ts = convert.domain_state(js, "cpu")
    jstep, tstep = jax.jit(jd.make_step()), td.make_step()
    g = jnp.asarray(G, jnp.float32)
    for _ in range(10):
        js, jst = jstep(js, g)
        ts, tst = tstep(ts, G)
    np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
    for field, atol, rtol in TOLS:
        np.testing.assert_allclose(getattr(ts.fluid, field).numpy(),
                                   np.asarray(getattr(js.fluid, field)),
                                   atol=atol, rtol=rtol, err_msg=field)
    assert int(tst["overflow"]) == int(jst["overflow"]) == 0
    assert int(tst["n_valid"]) == int(jst["n_valid"]) == setup["fluid"].n
    for key in ("max_rho_error_pct", "max_speed"):
        np.testing.assert_allclose(float(tst[key]), float(jst[key]), rtol=1e-6)
    back = convert.to_numpy(ts)
    assert set(back) == {"fluid", "ids", "au", "av"} and set(back["fluid"]) == set(FIELDS)


def test_migration_across_slabs(setup):
    """test_parallel.py:70-93: a strong rightward velocity carries the
    fluid across slab edges; identities and the count survive."""
    _, td = _domains(setup, 4)
    f = setup["tfluid"]
    state = td.init(f._replace(u=torch.full_like(f.u, 3.0)))
    step = td.make_step()
    for _ in range(60):
        state, st = step(state, (3.0, -9.81))
    assert int(st["n_valid"]) == f.n
    assert int(st["overflow"]) == 0
    got = td.gather(state)
    assert got.x.shape[0] == f.n
    ids = state.ids.numpy()
    np.testing.assert_array_equal(np.sort(ids[ids >= 0]), np.arange(f.n))
    assert float(got.x.mean()) > float(f.x.mean()) + 0.015
    slab0 = np.clip((f.x.numpy() / td.slab_w).astype(int), 0, 3)
    slab1 = np.clip((got.x.numpy() / td.slab_w).astype(int), 0, 3)
    assert (slab0 != slab1).sum() > 0
