"""The port's SimRunner(backend="window") against the JAX package's
SimRunner(backend="pallas") on the drop, same gravity source, same K.

The JAX runner builds exact-start engines (planes=1, band=0) in interpret
mode, the layout the port implements, so that window lengths, overflow
counts and every recovery decision can be compared one for one."""

import io

import jax
import numpy as np
import torch

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.io.display import FileSink as JFileSink
from pi_sph_fluid_tpu.io.gravity import ConstantGravity as JConstantGravity
from pi_sph_fluid_tpu.io.host_loop import SimRunner as JSimRunner
from pi_sph_fluid_tpu.render.metaballs_window import WindowRenderer as JWindowRenderer

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import convert
from pi_sph_fluid_tpu_torch.io.display import FileSink
from pi_sph_fluid_tpu_torch.io.gravity import ConstantGravity

torch.set_num_threads(1)

KW = dict(tq=32, qb=8, cap=256, seg_q=2)
J_OPTS = dict(planes=1, band=0, interpret=True)
KEYS = ("WINDOW OVERFLOW", "RESORT LADDER", "STALE DRIFT:")


def _runners(jfluid, **kw):
    cfg = J.SPHConfig()
    _, braw = J.build_drop_scene(cfg)
    opts = kw.pop("engine_opts")
    jr = JSimRunner(cfg, jfluid, braw, backend="pallas",
                    engine_opts=dict(opts, **J_OPTS), **kw)
    tr = T.SimRunner(T.SPHConfig(), convert.fluid_state(jfluid, "cpu"),
                     convert.boundary_state(braw, "cpu"), backend="window",
                     engine_opts=opts, device="cpu", **kw)
    return cfg, jr, tr


def _by_id(unpadded):
    return {f: np.asarray(getattr(unpadded, f)) for f in ("x", "y", "u", "v")}


def test_frames_and_state_match_jax(tmp_path):
    """Two dispatches of 4 exact ticks with a rendered frame each: the
    frames agree >= 99.5%, and exactly wherever the JAX field is not within
    1e-3 of the threshold; the final state is within the engine gates of
    test_torch_engine.py (x, y 2e-6 m; u, v 2e-4 m/s)."""
    jfluid, _ = J.build_drop_scene(J.SPHConfig())
    cfg, jr, tr = _runners(jfluid, engine_opts=dict(KW), render=True,
                           resort_every=1)
    paths = (tmp_path / "jax.bin", tmp_path / "port.bin")
    jsink, tsink = JFileSink(str(paths[0])), FileSink(str(paths[1]))
    jres = jr.run(JConstantGravity(cfg), jsink, sim_seconds=8 * cfg.dt,
                  steps_per_dispatch=4)
    tres = tr.run(ConstantGravity(tr.cfg), tsink, sim_seconds=8 * cfg.dt,
                  steps_per_dispatch=4)
    jsink.close()
    tsink.close()
    jframes, tframes = (np.fromfile(p, np.uint8).reshape(-1, 1024) for p in paths)
    assert jframes.shape == tframes.shape == (2, 1024)
    for a, b in zip(jframes, tframes):
        assert (T.unpack_framebuffer(a) == T.unpack_framebuffer(b)).mean() >= 0.995
    field, _ = jax.jit(JWindowRenderer(jr.engine).field)(jres.sim)
    field = np.asarray(field)
    confident = np.abs(field - 1.0) > 1e-3
    np.testing.assert_array_equal(T.unpack_framebuffer(tframes[-1]).ravel()[confident],
                                  field[confident] >= 1.0)
    a, b = _by_id(jr.engine.unpad(jres.sim)), _by_id(tr.engine.unpad(tres.sim))
    for f, atol in (("x", 2e-6), ("y", 2e-6), ("u", 2e-4), ("v", 2e-4)):
        np.testing.assert_allclose(b[f], a[f], atol=atol, err_msg=f)
    assert tres.reporter.total_overflow == jres.reporter.total_overflow == 0


def test_recovery_and_ladder_lines_match_jax():
    """cap=128 forced (qb=16 windows overflow it), a 60 m/s particle and the
    upward ladder from resort_every=2: both runners grow the cap, climb,
    trip and downgrade alike, printing the same WINDOW OVERFLOW / RESORT
    LADDER / STALE DRIFT lines and counting the same recoveries."""
    jfluid, _ = J.build_drop_scene(J.SPHConfig())
    u = np.asarray(jfluid.u).copy()
    u[0] = np.float32(60.0)
    jfluid = jfluid._replace(u=jax.numpy.asarray(u))
    cfg, jr, tr = _runners(jfluid, engine_opts=dict(KW, qb=16, cap=128),
                           render=False, resort_every=2, max_resort=8,
                           raise_after=1)
    logs = io.StringIO(), io.StringIO()
    jres = jr.run(JConstantGravity(cfg), sim_seconds=0.04, steps_per_dispatch=16,
                  report_stream=logs[0], report_every=0.004)
    tres = tr.run(ConstantGravity(tr.cfg), sim_seconds=0.04, steps_per_dispatch=16,
                  report_stream=logs[1], report_every=0.004)
    jlines, tlines = ([ln for ln in log.getvalue().splitlines()
                       if any(k in ln for k in KEYS) and not ln.startswith("sim time")]
                      for log in logs)
    assert tlines == jlines
    assert {k for k in KEYS if any(k in ln for ln in tlines)} == set(KEYS)
    assert tres.recoveries == jres.recoveries >= 3
    assert (tr._resort, tr._resort_ceiling, tr.engine.spec.cap) == \
        (jr._resort, jr._resort_ceiling, jr.engine.spec.cap)
    assert tres.reporter.total_overflow == jres.reporter.total_overflow == 0
    assert tres.reporter.total_stale == jres.reporter.total_stale == 0
