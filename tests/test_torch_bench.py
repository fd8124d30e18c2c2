"""The port's headline bench (`python -m pi_sph_fluid_tpu_torch.bench`) run
small on the CPU, through the kernels' plain versions."""

import json
import pathlib

import pytest
import torch

from pi_sph_fluid_tpu_torch import bench

torch.set_num_threads(1)

# bench.py's headline keys, less its slab-DD rows and its TPU-headline echo
KEYS = {"metric", "value", "unit", "vs_baseline", "n_fluid", "steps", "wall_s",
        "ps_per_s_min", "ps_per_s_max", "exact_ps_per_s", "resort_every",
        "stale_drift", "scene", "max_rho_error_pct", "neighbor_overflow",
        "frame_ms", "render_overflow", "m1", "smallN_ticks_per_s",
        "smallN_vs_realtime", "backend", "device", "not_ported"}


def test_bench_prints_the_headline_line(capsys, monkeypatch):
    """One JSON line with bench.py's keys, the DD rows named as not ported,
    overflow and stale 0, and no BENCH_r*.json read."""
    opened = []
    real_open = open

    def spy(path, *a, **kw):
        opened.append(str(path))
        return real_open(path, *a, **kw)

    monkeypatch.setattr("builtins.open", spy)
    out = bench.main(["--device", "cpu", "--n", "1000", "--steps", "64",
                      "--m1-n", "1500", "--small-steps", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(out))
    assert set(line) == KEYS
    assert line["not_ported"] == ["dd", "dd_strong"]
    assert not any(k.startswith("prev_") or k.startswith("dd") for k in line)
    assert not any(pathlib.Path(p).name.startswith("BENCH_r") for p in opened)
    assert line["device"] == "cpu" and line["backend"] == "window"
    assert line["neighbor_overflow"] == 0 and line["stale_drift"] == 0
    assert line["render_overflow"] == 0
    assert line["m1"]["neighbor_overflow"] == 0 and line["m1"]["stale_drift"] == 0
    assert line["steps"] == 64 and line["resort_every"] == 64
    assert line["ps_per_s_min"] <= line["value"] <= line["ps_per_s_max"]
    assert line["value"] > 0 and line["exact_ps_per_s"] > 0 and line["frame_ms"] > 0
    assert line["smallN_ticks_per_s"] > 0 and line["m1"]["n_fluid"] > line["n_fluid"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / (431 * 4102))


def test_bench_without_a_card_raises():
    """--device cuda (the default) raises on a machine without a card
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for argv in (["--device", "cuda"], []):
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench.main(argv)


def test_bench_refuses_steps_off_the_resort_period():
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--steps", "100"])
