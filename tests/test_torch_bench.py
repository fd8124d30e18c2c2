"""The port's headline bench (`python -m pi_sph_fluid_tpu_torch.bench`) run
small on the CPU, through the kernels' plain versions."""

import json
import pathlib

import pytest
import torch

from pi_sph_fluid_tpu_torch import bench

torch.set_num_threads(1)

# bench.py's headline keys, less its TPU-headline echo, plus the r8 rate,
# the spread of the exact rate and the 256x128 frame
KEYS = {"metric", "value", "unit", "vs_baseline", "n_fluid", "steps", "wall_s",
        "ps_per_s_min", "ps_per_s_max", "exact_ps_per_s", "exact_ps_per_s_min",
        "exact_ps_per_s_max", "r8_ps_per_s", "r8_ps_per_s_min", "r8_ps_per_s_max",
        "resort_every", "stale_drift", "scene", "max_rho_error_pct",
        "neighbor_overflow", "frame_ms", "frame_ms_256x128", "render_overflow", "m1",
        "dd", "dd_strong", "smallN_ticks_per_s", "smallN_vs_realtime", "backend",
        "device"}
# bench.py's dd row (`bench.py:172-229`) less its projected 8-chip figure,
# plus the field that says so
DD_KEYS = ["slabs_measured", "n_fluid_per_slab", "ps_per_s_per_slab", "ms_per_step",
           "resort_every", "overflow", "stale_drift", "scaling_across_cards"]


def test_bench_prints_the_headline_line(capsys, monkeypatch):
    """One JSON line with bench.py's keys, the DD rows measured on one slab
    with nothing projected, overflow and stale 0, and no BENCH_r*.json
    read."""
    opened = []
    real_open = open

    def spy(path, *a, **kw):
        opened.append(str(path))
        return real_open(path, *a, **kw)

    monkeypatch.setattr("builtins.open", spy)
    out = bench.main(["--device", "cpu", "--n", "1000", "--steps", "64",
                      "--m1-n", "1500", "--small-steps", "16", "--dd-n", "2000"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(out))
    assert set(line) == KEYS
    assert not any(k.startswith("prev_") or k == "not_ported" for k in line)
    rows = [line["dd"], *line["dd_strong"].values()]
    assert list(line["dd_strong"]) == ["slab_1000", "slab_500"]
    for row, n in zip(rows, (2000, 1000, 500)):
        assert list(row) == DD_KEYS and row["slabs_measured"] == 1
        assert row["overflow"] == 0 and row["stale_drift"] == 0
        assert row["resort_every"] == 64 and row["ps_per_s_per_slab"] > 0
        assert abs(row["n_fluid_per_slab"] - n) < 0.1 * n
        assert "not measured" in row["scaling_across_cards"]
        assert not any("projected" in k or "derived" in k for k in row)
    assert not any(pathlib.Path(p).name.startswith("BENCH_r") for p in opened)
    assert line["device"] == "cpu" and line["backend"] == "window"
    assert line["neighbor_overflow"] == 0 and line["stale_drift"] == 0
    assert line["render_overflow"] == 0
    assert line["m1"]["neighbor_overflow"] == 0 and line["m1"]["stale_drift"] == 0
    assert line["steps"] == 64 and line["resort_every"] == 64
    for key in ("ps_per_s", "exact_ps_per_s", "r8_ps_per_s"):
        value = line["value" if key == "ps_per_s" else key]
        assert 0 < line[f"{key}_min"] <= value <= line[f"{key}_max"]
    assert line["frame_ms"] > 0 and line["frame_ms_256x128"] > 0
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
