"""The port's copied host I/O (gravity sources, display sinks, the web sink,
the native host runtime) and its CLI, on the CPU.

The copies are held byte for byte against the JAX package's modules on the
same inputs; the CLI's checkpoints resume bitwise, and a checkpoint the JAX
package's CLI writes resumes in the port's CLI through the raw layout
arrays (the `cli.py:158-178` path)."""

import io
import json
import time

import numpy as np
import pytest
import torch

import pi_sph_fluid_tpu as J
from pi_sph_fluid_tpu import cli as jcli
from pi_sph_fluid_tpu.io import display as jdisplay
from pi_sph_fluid_tpu.io import gravity as jgravity
from pi_sph_fluid_tpu.io.native import blit_halfblocks as j_blit

import pi_sph_fluid_tpu_torch as T
from pi_sph_fluid_tpu_torch import cli
from pi_sph_fluid_tpu_torch.io import display, gravity, native

torch.set_num_threads(1)

CFG = T.SPHConfig()
DT = CFG.dt


def _frames(n, rows=64, cols=128, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=rows // 8 * cols, dtype=np.uint8) for _ in range(n)]


def test_gravity_sources_match_jax():
    """Constant, rotating and recorded-trace sources give JAX's traces,
    bitwise, over several batches (their clocks advance alike)."""
    samples = np.asarray([[0.0, -9.81], [1.0, -9.0], [2.0, -8.0]], np.float32)
    pairs = [
        (gravity.ConstantGravity(CFG), jgravity.ConstantGravity(J.SPHConfig())),
        (gravity.RotatingGravity(CFG, period_s=0.05),
         jgravity.RotatingGravity(J.SPHConfig(), period_s=0.05)),
        (gravity.TraceGravity(samples, sample_hz=10.0, loop=False),
         jgravity.TraceGravity(samples, sample_hz=10.0, loop=False)),
    ]
    for ours, theirs in pairs:
        for k in (16, 410, 4):
            np.testing.assert_array_equal(ours.trace(k, DT), theirs.trace(k, DT))
        np.testing.assert_array_equal(ours.current(), theirs.current())


@pytest.mark.parametrize("sink", ["file", "png", "gif", "terminal"])
def test_sinks_match_jax(tmp_path, sink):
    """The same frames through the port's sink and the JAX package's give
    the same bytes (files, PNGs, the GIF stream, the terminal text)."""
    frames = _frames(3, 32, 64)
    outs = []
    for mod, tag in ((display, "t"), (jdisplay, "j")):
        if sink == "file":
            s = mod.FileSink(str(tmp_path / f"{tag}.bin"))
        elif sink == "png":
            s = mod.PngSink(str(tmp_path / tag), 32, 64, scale=2)
        elif sink == "gif":
            s = mod.GifSink(str(tmp_path / f"{tag}.gif"), 32, 64, scale=2, fps=25)
        else:
            stream = io.StringIO()
            s = mod.TerminalSink(32, 64, stream=stream)
        for fb in frames:
            s.push(fb)
        s.close()
        if sink == "file":
            outs.append((tmp_path / f"{tag}.bin").read_bytes())
        elif sink == "png":
            outs.append(b"".join((tmp_path / f"{tag}_{k:06d}.png").read_bytes()
                                 for k in range(3)))
        elif sink == "gif":
            outs.append((tmp_path / f"{tag}.gif").read_bytes())
        else:
            outs.append(stream.getvalue().encode())
    assert outs[0] == outs[1] and len(outs[0]) > 0


def test_native_blit_and_pacing():
    """The port builds its own copy of host_io.c (into build/, not the JAX
    package's csrc/); blit text equals the JAX package's; pacing reaches
    its deadline."""
    fb = _frames(1)[0]
    assert native.blit_halfblocks(fb, 64, 128) == j_blit(fb, 64, 128)
    if native.load() is not None:
        assert "build" in str(native.load()._name)
    deadline = time.monotonic() + 0.01
    assert native.pace_until(deadline) >= 0.0
    assert time.monotonic() >= deadline


def test_async_sink_drops_rather_than_blocks():
    class Slow:
        got = 0

        def push(self, fb):
            time.sleep(0.05)
            self.got += 1

        def close(self):
            pass

    inner = Slow()
    sink = display.AsyncSink(inner)
    t0 = time.perf_counter()
    for _ in range(50):
        sink.push(np.zeros(1024, np.uint8))
    fast = time.perf_counter() - t0 < 0.5
    sink.close()
    assert fast and 0 < inner.got < 50


def test_web_sink_and_gravity():
    """The browser sink serves the frame and its metadata on localhost, and
    a POSTed tilt drives WebGravity (test_io.py:308-368)."""
    from urllib.request import Request, urlopen

    from pi_sph_fluid_tpu_torch.io.web import WebSink

    sink = WebSink(port=0, rows=64, cols=128)
    try:
        fb = np.arange(1024, dtype=np.uint8)
        sink.push(fb)
        base = f"http://127.0.0.1:{sink.port}"
        assert b"canvas" in urlopen(f"{base}/", timeout=5).read()
        assert json.loads(urlopen(f"{base}/meta", timeout=5).read()) == \
            {"rows": 64, "cols": 128, "frames": 1}
        assert urlopen(f"{base}/frame", timeout=5).read() == fb.tobytes()
        src = gravity.WebGravity(CFG, sink)
        np.testing.assert_allclose(src.current(), [0.0, -CFG.g])
        req = Request(f"{base}/gravity", method="POST",
                      data=json.dumps({"tx": 3.0, "ty": 4.0}).encode())
        assert urlopen(req, timeout=5).status == 204
        np.testing.assert_allclose(src.current(), [0.6 * CFG.g, 0.8 * CFG.g], rtol=1e-6)
    finally:
        sink.close()


def test_cli_web_gravity_needs_web_display():
    with pytest.raises(SystemExit, match="--display web"):
        cli.main(["run", "--device", "cpu", "--scene", "drop", "--seconds", "0.01",
                  "--display", "none", "--gravity", "web"])


def test_cli_has_no_cpu_fallback():
    """Without a GPU, the default --device cuda fails at its first CUDA
    tensor instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        cli.main(["run", "--scene", "drop", "--display", "none", "--seconds", "0.001"])


def _run(extra):
    return cli.main(["run", "--device", "cpu", "--scene", "drop", "--display",
                     "none", "--steps-per-dispatch", "4", "--resort-every", "2",
                     "--cap", "256"] + extra)


def test_cli_resume_is_bitwise(tmp_path):
    """8 ticks saved and resumed for 8 more equal 16 continuous ticks,
    bitwise: the npz carries packed, ids, au, av (test_io.py:460)."""
    half, cont, res = (str(tmp_path / f) for f in ("half.npz", "cont.npz", "res.npz"))
    _run(["--seconds", repr(8 * DT), "--save-state", half])
    _run(["--seconds", repr(16 * DT), "--save-state", cont])
    _run(["--seconds", repr(8 * DT), "--load-state", half, "--save-state", res])
    a, b = np.load(cont), np.load(res)
    for key in ("packed", "au", "av", "ids", "fluid.x", "fluid.u"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_jax_cli_checkpoint_resumes_in_port(tmp_path, capsys):
    """A checkpoint written by the JAX package's CLI (`run --save-state`)
    resumes in the port's CLI through its raw layout arrays, not a re-prime:
    the port continues from the JAX state, within the engine gates of a
    JAX state stepped alike (x, y 2e-6 m; u, v 2e-4 m/s)."""
    ck, res = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcli.main(["run", "--scene", "drop", "--backend", "pallas", "--display", "none",
               "--steps-per-dispatch", "4", "--resort-every", "1", "--cap", "256",
               "--seconds", repr(4 * DT), "--save-state", ck])
    capsys.readouterr()
    _run(["--seconds", repr(4 * DT), "--load-state", ck, "--save-state", res,
          "--resort-every", "1"])
    err = capsys.readouterr().err
    assert "resumed 269 particles" in err and "re-priming" not in err
    j, t = np.load(ck), np.load(res)
    assert t["packed"].shape == j["packed"].shape
    assert sorted(t["ids"][t["ids"] >= 0]) == list(range(269))
    # the JAX state stepped 4 more ticks by the port's own engine from the
    # same arrays, outside the CLI
    cfg = T.SPHConfig()
    fluid, braw = T.build_drop_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, "cpu", cap=256)
    sim = T.PackedSim(*(torch.as_tensor(j[k]) for k in ("packed", "ids", "au", "av")))
    sim, _ = eng.make_multi_step()(sim, np.tile(np.float32([0.0, -9.81]), (4, 1)))
    np.testing.assert_array_equal(t["packed"], sim.packed.numpy())
    assert not np.array_equal(t["fluid.x"], j["fluid.x"])


def test_cli_run_and_bench_json(tmp_path, capsys):
    """`run` returns its RunResult and writes one frame per dispatch: the
    file display is not behind the CLI's AsyncSink (whose live displays drop
    a frame that finds the writer busy, as the JAX package's do), so the 2
    dispatches write exactly 2 whole 1024-byte frames.  `bench` prints one
    JSON line naming its device."""
    path = tmp_path / "f.bin"
    res = cli.main(["run", "--device", "cpu", "--scene", "drop", "--display",
                    f"file:{path}", "--seconds", repr(16 * DT),
                    "--steps-per-dispatch", "8"])
    assert res.steps == 16 and res.reporter.total_overflow == 0
    size = path.stat().st_size
    assert size == 2 * 1024, size
    capsys.readouterr()
    out = cli.main(["bench", "--device", "cpu", "--n", "2000", "--steps", "8",
                    "--render"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["device"] == "cpu" and line["neighbor_overflow"] == 0
    assert line["value"] > 0 and line["steps"] == 8
