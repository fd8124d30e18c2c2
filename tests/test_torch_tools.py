"""The port's tools (pi_sph_fluid_tpu_torch/tools/: frames_to_gif,
render_probe, dd_probe, dynamic_stale_probe, cfl_probe) through their
``main([... "--device", "cpu"])`` at a tiny size, on the kernels' plain
versions; frames_to_gif and dynamic_stale_probe against the JAX package."""

import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu.models.engine_v3 import WindowEngine as JEngine
from pi_sph_fluid_tpu.render.metaballs import unpack_framebuffer
from test_io import _parse_gif

from pi_sph_fluid_tpu_torch.tools import (cfl_probe, dd_probe, dynamic_stale_probe,
                                          frames_to_gif, render_probe)

torch.set_num_threads(1)

TOOLS_DIR = pathlib.Path(__file__).resolve().parents[1] / "tools"


def test_frames_to_gif_matches_the_jax_tool(tmp_path):
    """A FileSink capture of 4 seeded frames converts to a GIF that decodes
    to the frames (test_io.py::test_frames_to_gif_tool) and is byte-equal
    to what the JAX package's tools/frames_to_gif.py writes from it."""
    sys.path.insert(0, str(TOOLS_DIR))
    try:
        import frames_to_gif as jax_frames_to_gif
    finally:
        sys.path.pop(0)

    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(4, 8 * 128), dtype=np.uint8)
    cap = tmp_path / "frames.bin"
    cap.write_bytes(frames.tobytes())
    out, ref = tmp_path / "out.gif", tmp_path / "jax.gif"
    got = frames_to_gif.main([str(cap), str(out), "--scale", "1", "--device", "cpu"])
    assert got == dict(device="cpu", frames_in=4, frames_out=4,
                       gif_bytes=out.stat().st_size)
    w, h, _, decoded = _parse_gif(out.read_bytes())
    assert (w, h) == (128, 64) and len(decoded) == 4
    for fb, px in zip(frames, decoded):
        np.testing.assert_array_equal(np.asarray(px).reshape(h, w),
                                      unpack_framebuffer(fb, 64, 128).astype(np.uint8))
    jax_frames_to_gif.main([str(cap), str(ref), "--scale", "1"])
    assert out.read_bytes() == ref.read_bytes()


def test_render_probe_small_pool():
    out = render_probe.main(["--n", "2000", "--reps", "1", "--device", "cpu"])
    assert out["device"] == "cpu" and out["n"] > 1500
    assert out["step_overflow"] == 0
    assert out["reuse_overflow"] == 0 and out["self_overflow"] == 0
    assert out["reuse_cap"] > 0 and out["self_cap"] > 0 and out["px_layout"] >= 64 * 128
    assert out["render_from_frame_ms"] > 0 and out["self_relayout_ms"] > 0


def test_dd_probe_keeps_every_particle():
    out = dd_probe.main(["--n", "2000", "--steps", "8", "--device", "cpu"])
    for k in dd_probe.RESORTS:
        row = out[f"r{k}"]
        assert row["n_valid"] == out["n"] and row["overflow"] == 0, (k, row)
        assert row["ms_per_step"] > 0


def test_cfl_probe_reports_each_factor():
    """A few hundred particles for 0.11 sim-s at dt factors 1.0 and 0.4: at
    least one 0.1 sim-s report row a factor, under the C/10 bound."""
    out = cfl_probe.main(["--n", "300", "--seconds", "0.11", "--settle", "0",
                          "--dispatch", "32", "--device", "cpu"])
    assert set(out["factors"]) == {1.0, 0.4}
    for f, res in out["factors"].items():
        assert len(res["rows"]) >= 1, f
        assert res["overflow"] == 0 and res["stale"] == 0, (f, res)
        assert 0 < res["peak"] < cfl_probe.SPEED_BOUND, (f, res)
        assert res["rows"][0][0] >= 0.1


def test_dynamic_stale_probe_matches_jax_engine():
    """The window backend's stale, overflow and max speed per resort period
    on the small dam (r = sqrt(2.56 / 400)) equal the JAX WindowEngine's
    through the same sequence (prime, 32 damped ticks at resort_every 4, no
    pre-roll, 32 ticks at resort_every 4 and 8 from the same state), in
    interpret mode: stale and overflow exactly, max speed within rtol 1e-4
    (test_torch_engine.py's sticky gate).  Both engines run the same block
    shape, tq = qb = 8 at cap 128, the smallest JAX's interpret mode unrolls."""
    k_list, settle, steps = (4, 8), 32, 32
    out = dynamic_stale_probe.main([
        "--n", "400", "--settle", str(settle), "--preroll-s", "0",
        "--steps", str(steps), "--resorts", ",".join(map(str, k_list)),
        "--cap", "128", "--tq", "8", "--qb", "8", "--device", "cpu"])
    assert out["preroll_ticks"] == 0 and "preroll" not in out

    cfg = J.SPHConfig(r=math.sqrt(2.56 / 400), dt_factor=0.4)
    fluid, braw = J.build_dam_break_scene(cfg)
    b, bg = J.prepare_boundary(braw, cfg)
    assert out["n"] == fluid.n
    eng = JEngine(cfg, b, bg, fluid.n, tq=8, qb=8, cap=128, planes=1, band=0,
                  interpret=True)

    def g(n):
        return jnp.broadcast_to(jnp.asarray((0.0, -9.81), jnp.float32), (n, 2))

    sim = eng.prime(fluid, (0.0, -9.81))
    sim, _ = jax.jit(eng.make_multi_step(damping=0.995, resort_every=4))(sim, g(settle))
    for k in k_list:
        _, st = jax.jit(eng.make_multi_step(resort_every=k))(sim, g(steps))
        row = out[f"r{k}"]
        assert row["stale"] == int(jnp.sum(st.stale)), (k, row)
        assert row["overflow"] == int(jnp.max(st.neighbor_overflow)), (k, row)
        np.testing.assert_allclose(row["max_speed"], float(jnp.max(st.max_speed)),
                                   rtol=1e-4)


@pytest.mark.parametrize("tool,argv", [
    (frames_to_gif, ["frames.bin", "out.gif"]),
    (render_probe, []),
    (dd_probe, []),
    (dynamic_stale_probe, []),
    (cfl_probe, []),
])
def test_tool_needs_a_card_unless_asked_for_the_cpu(tool, argv):
    """``--device`` defaults to cuda, and without a card a tool exits
    before any work: there is no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(argv)
