"""Port (pi_sph_fluid_tpu_torch) vs the JAX package: config, core math,
scenes, boundary pseudo-mass, checkpoints, and the port's import hygiene.

Every comparison feeds the same numpy-made inputs to both packages."""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.core import eos as j_eos
from pi_sph_fluid_tpu.core import kernels as j_kernels
from pi_sph_fluid_tpu.core.pair_terms import artificial_pressure_ref_w as j_wref
from pi_sph_fluid_tpu.ops.grid import build_grid as j_build_grid

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import convert
from pi_sph_fluid_tpu_torch.core import eos as t_eos
from pi_sph_fluid_tpu_torch.core import kernels as t_kernels
from pi_sph_fluid_tpu_torch.core.pair_terms import artificial_pressure_ref_w as t_wref
from pi_sph_fluid_tpu_torch.ops.grid import build_grid as t_build_grid

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
RADII = [0.075, 0.0226, 0.00797]
DERIVED = ["h", "dt", "particle_volume", "particle_mass", "support_radius",
           "kernel_norm", "tait_b", "cell_length", "n_cell_rows",
           "n_cell_cols", "n_cells"]


@pytest.mark.parametrize("r", RADII)
def test_config_derived_constants_equal(r):
    jc, tc = J.SPHConfig(r=r), T.SPHConfig(r=r)
    for name in DERIVED:
        assert getattr(tc, name) == getattr(jc, name), name
    assert t_wref(tc) == j_wref(jc)


@pytest.mark.parametrize("r", RADII)
def test_kernel_and_eos_match(r):
    """W(q) and the Tait EOS on seeded inputs: same float32 operation order,
    so equal to 1 ulp (rtol 2.4e-7).  W(dx, dy): XLA on the CPU may fuse
    dx*dx + dy*dy into one FMA, so r can differ by an ulp, which
    (1 - q/2)^4 amplifies near the support edge: rtol 1e-5 with an atol of
    1e-6 of W(0)."""
    jc, tc = J.SPHConfig(r=r), T.SPHConfig(r=r)
    rng = np.random.default_rng(1)
    q = rng.uniform(0, 2.5, 4096).astype(np.float32)
    dx = rng.uniform(-3, 3, 4096).astype(np.float32) * np.float32(jc.h)
    dy = rng.uniform(-3, 3, 4096).astype(np.float32) * np.float32(jc.h)
    rho = rng.uniform(900, 1100, 4096).astype(np.float32)
    exact = [
        (j_kernels.w_at_q(jnp.asarray(q), jc), t_kernels.w_at_q(torch.as_tensor(q), tc)),
        (j_eos.tait_pressure(jnp.asarray(rho), jc),
         t_eos.tait_pressure(torch.as_tensor(rho), tc)),
    ]
    for a, b in exact:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2.4e-7, atol=0)
    w_j = j_kernels.kernel_w(jnp.asarray(dx), jnp.asarray(dy), jc)
    w_t = t_kernels.kernel_w(torch.as_tensor(dx), torch.as_tensor(dy), tc)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5,
                               atol=1e-6 * jc.kernel_norm)
    assert t_kernels.w_self(tc) == j_kernels.w_self(jc)


@pytest.mark.parametrize("name,r", [
    ("drop", 0.075), ("drop", 0.0226), ("dam", 0.075), ("pool", 0.03)])
def test_scenes_bitwise(name, r):
    jc, tc = J.SPHConfig(r=r), T.SPHConfig(r=r)
    jf, jb = getattr(J, f"build_{name}_scene" if name != "dam"
                     else "build_dam_break_scene")(jc)
    tf, tb = getattr(T, f"build_{name}_scene" if name != "dam"
                     else "build_dam_break_scene")(tc, "cpu")
    for a, b in list(zip(jf, tf)) + list(zip(jb, tb)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_build_grid_equal():
    """Cell ids are bitwise JAX's, so the sort and CSR agree exactly, also
    for positions on and beyond the domain edges."""
    cfg = J.SPHConfig(r=0.0226)
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.2, 4.2, 5000).astype(np.float32)
    y = rng.uniform(-0.2, 2.2, 5000).astype(np.float32)
    x[:64] = np.float32(cfg.cell_length) * np.arange(64, dtype=np.float32)
    a = j_build_grid(jnp.asarray(x), jnp.asarray(y), cfg)
    b = t_build_grid(torch.as_tensor(x), torch.as_tensor(y), T.SPHConfig(r=0.0226))
    for fa, fb in zip(a, b):
        assert fb.dtype == torch.int32
        np.testing.assert_array_equal(fb.numpy(), np.asarray(fa))


@pytest.mark.parametrize("r", [0.075, 0.0226])
def test_prepare_boundary_pseudo_mass(r):
    """Same boundary order and cell CSR; pseudo-mass within rtol 1e-6 (the
    neighbour sums run in another order)."""
    jc, tc = J.SPHConfig(r=r), T.SPHConfig(r=r)
    _, jraw = J.build_drop_scene(jc)
    _, traw = T.build_drop_scene(tc, "cpu")
    jb, jg = J.prepare_boundary(jraw, jc)
    tb, tg = T.prepare_boundary(traw, tc)
    np.testing.assert_array_equal(tb.x.numpy(), np.asarray(jb.x))
    np.testing.assert_array_equal(tb.y.numpy(), np.asarray(jb.y))
    np.testing.assert_array_equal(tg.cell_starts.numpy(), np.asarray(jg.cell_starts))
    np.testing.assert_allclose(tb.m.numpy(), np.asarray(jb.m), rtol=1e-6)


def test_checkpoints_cross_load(tmp_path):
    """The npz format is shared: a JAX checkpoint loads into the port and a
    port checkpoint loads into the JAX package, bitwise."""
    cfg = J.SPHConfig()
    jf, jb = J.build_drop_scene(cfg)
    J.save_state(str(tmp_path / "j.npz"), fluid=jf, boundary=jb,
                 step=np.int32(7))
    got = T.load_state(str(tmp_path / "j.npz"), "cpu")
    assert isinstance(got["fluid"], T.FluidState)
    assert isinstance(got["boundary"], T.BoundaryState)
    assert int(got["step"]) == 7
    for a, b in zip(jf, got["fluid"]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    T.save_state(str(tmp_path / "t.npz"), fluid=got["fluid"])
    back = J.load_state(str(tmp_path / "t.npz"))
    for a, b in zip(jf, back["fluid"]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_convert_roundtrip():
    cfg = J.SPHConfig()
    jf, _ = J.build_drop_scene(cfg)
    tf = convert.fluid_state(jf, "cpu")
    back = convert.to_numpy(tf)
    assert set(back) == set(J.FluidState._fields)
    for f in J.FluidState._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jf, f)))


def test_port_imports_no_jax_and_cpu_path_launches_nothing():
    """In a fresh interpreter the port (the renderer, the host loop, the
    CLI, the bench, the probes, the jnp oracle, the slab decomposition, its
    launch plumbing and worker, the dry runs and the tools of physics and
    card included) leaves JAX out
    of sys.modules, and a primed CPU run, a render,
    a 2-slab step, a 2-slab sticky group and its frame, a window-dd runner
    and both probes go through the plain versions only (counters at 0)."""
    code = (
        "import sys, torch\n"
        "import pi_sph_fluid_tpu_torch as T\n"
        "from pi_sph_fluid_tpu_torch import bench, cli, convert, dryrun\n"
        "from pi_sph_fluid_tpu_torch.io import display, gravity, host_loop, native, web\n"
        "from pi_sph_fluid_tpu_torch.models import simulation\n"
        "from pi_sph_fluid_tpu_torch.ops import forces, sph_operators\n"
        "from pi_sph_fluid_tpu_torch.ops.window import window_kernels as wk\n"
        "from pi_sph_fluid_tpu_torch.parallel import comm, domain, domain_window, launch\n"
        "from pi_sph_fluid_tpu_torch.tools import multihost_worker\n"
        "from pi_sph_fluid_tpu_torch.render import metaballs, metaballs_window as mw\n"
        "from pi_sph_fluid_tpu_torch.tools import span_dma_probe as sp\n"
        "from pi_sph_fluid_tpu_torch.tools import unaligned_probe as up\n"
        "from pi_sph_fluid_tpu_torch.tools import forces_probe, launch_probe\n"
        "from pi_sph_fluid_tpu_torch.tools import (cfl_probe, dd_probe, dynamic_stale_probe,\n"
        "                                          frames_to_gif, render_probe)\n"
        "from pi_sph_fluid_tpu_torch.utils import profiling, stats\n"
        "from pi_sph_fluid_tpu_torch.utils.tracer import tracer\n"
        "cfg = T.SPHConfig()\n"
        "f, b = T.build_drop_scene(cfg, 'cpu')\n"
        "b, g = T.prepare_boundary(b, cfg)\n"
        "e = T.WindowEngine(cfg, b, g, f.n, 'cpu', tq=32, qb=8)\n"
        "s, st, fr = e.make_multi_step(return_frame=True)(e.prime(f, (0.0, -9.81)),\n"
        "                                                 [(0.0, -9.81)])\n"
        "fb, ov = T.WindowRenderer(e).render_from_frame(s, fr)\n"
        "dd = domain_window.WindowDomain(cfg, b, g, f.n, comm.LocalComm(2), 'cpu', tq=32, qb=8)\n"
        "dd.make_step()(dd.init(f), (0.0, -9.81))\n"
        "ds, _ = dd.make_multi_step(resort_every=2)(dd.init(f), [(0.0, -9.81)] * 2)\n"
        "dd.make_render()(ds)\n"
        "host_loop.SimRunner(cfg, f, T.build_drop_scene(cfg, 'cpu')[1], backend='window-dd',\n"
        "                    engine_opts=dict(slabs=2, tq=32, qb=8), device='cpu')\n"
        "simulation.make_multi_step(cfg, b, g)(simulation.prime(f, b, g, (0.0, -9.81), cfg),\n"
        "                                      [(0.0, -9.81)])\n"
        "src, al, un = up.make_starts(4096, 2)\n"
        "up.window_copy(torch.from_numpy(un), torch.from_numpy(src))\n"
        "sp.span_density(*sp.make_inputs(256, 1024, 4, 128, 'cpu'), 4, 128)\n"
        "for key in ('kernel.density.launches', 'kernel.forces.launches',\n"
        "            'kernel.field.launches', 'probe.window_copy.launches',\n"
        "            'probe.span_density.launches'):\n"
        "    assert tracer.counters.get(key, 0) == 0, (key, tracer.counters)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('pi_sph_fluid_tpu.') or m == 'pi_sph_fluid_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
