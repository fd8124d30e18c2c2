"""The dam_1m.surge cell at a small size on the CPU: the Colagrossi-Landrini
column of configs/dam_1m.json (its geometry, c and dt_factor) at R = 0.0167 m
(3,784 fluid particles), run through the harness under the cell's own
limits, and the same scene under a pinned r8 mix, where the front's impact
on the far wall trips the stale guard inside the window."""

import time

import numpy as np
import pytest

from benchmark import harness, scene
from benchmark.spec import Spec
from conftest import ROOT

SMALL_R = 0.0167
SEED = 2147483711


def _lattice_counts(cfg: dict) -> tuple:
    """(fluid, walls) of the dam's formula: the float32 lattice points from
    2 R off the left wall and the floor to fill_x of the width and fill_y of
    the height, and single-layer walls, two a lattice point of each side."""
    xs = scene.float32_lattice(cfg["width"], cfg["r"])
    ys = scene.float32_lattice(cfg["height"], cfg["r"])
    f32 = np.float32
    gap = f32(2.0) * f32(cfg["r"])
    nx = int(((xs >= gap) & (xs < f32(cfg["width"]) * f32(cfg["fill_x"]))).sum())
    ny = int(((ys >= gap) & (ys < f32(cfg["height"]) * f32(cfg["fill_y"]))).sum())
    return nx * ny, 2 * (len(xs) + len(ys))


def _small() -> dict:
    cfg = dict(Spec(ROOT).config("dam_1m"), r=SMALL_R)
    cfg["n_fluid"], cfg["n_walls"] = _lattice_counts(cfg)
    return cfg


def _mix(**over) -> dict:
    """The cell's mix, cut for the CPU: 256 ticks a dispatch (the cell's
    pre-roll of 0.2 s is then 5 dispatches, t sqrt(g/H) = 0.75) and chunks
    of two dispatches, unless ``over`` says otherwise."""
    t = Spec(ROOT).traffic("dam_1m.surge")
    t.update(steps_per_dispatch=256, chunk_dispatches=2, trace_s=1.0)
    t.update(over)
    return t


def _run(traffic: dict, monkeypatch):
    """One traced run of the small dam reporting runner.revert_share, and
    the harness's Run of it (ticks run and committed)."""
    spec = Spec(ROOT)
    metric = next(m for m in spec.bench["per_layer"] if m["name"] == "runner.revert_share")
    seen = []
    make_run = harness.Run
    monkeypatch.setattr(harness, "Run", lambda **kw: seen.append(kw) or make_run(**kw))
    res = harness.run_cell(_small(), traffic, [metric],
                           {metric["name"]: spec.reader("per_layer", metric["name"])},
                           SEED, 0.5, True, "cpu", time.perf_counter(),
                           log=lambda *a, **k: None)
    return res, seen[0]


@pytest.mark.parametrize("r", ["dam_1m", SMALL_R])
def test_the_dam_counts_are_the_lattice_formula(r):
    cfg = Spec(ROOT).config("dam_1m") if r == "dam_1m" else _small()
    fluid, walls = _lattice_counts(cfg)
    built = scene.build_scene(cfg, SEED)
    assert (len(built["fluid_x"]), len(built["wall_x"])) == (fluid, walls)
    assert (cfg["n_fluid"], cfg["n_walls"]) == (fluid, walls)
    if r == "dam_1m":
        assert (fluid, walls) == (997_578, 11_386)
    # the column is 2H wide and H high, H = 4 / 5.366 m (Colagrossi & Landrini)
    h = 4.0 / 5.366
    assert built["fluid_x"].max() == pytest.approx(2 * h, abs=2 * cfg["r"])
    assert built["fluid_y"].max() == pytest.approx(h, abs=2 * cfg["r"])


def test_the_small_surge_is_correct(monkeypatch):
    """The r4 mix from the column's collapse (t sqrt(g/H) = 0.75) is correct
    against the plain reference under the cell's limits, with no revert."""
    res, run = _run(_mix(), monkeypatch)
    assert res["correct"] is True and res["failed"] == 0, (res["numbers"], res["limits"])
    assert res["checked"] == 2
    assert res["limits"] == dict(Spec(ROOT).traffic("dam_1m.surge")["check"]["limits"], failed=0)
    assert run["ticks_run"] == run["ticks_committed"] == 512
    assert res["metrics"]["runner.revert_share"]["value"] == 0.0


def test_r8_trips_and_revert_share_reads_the_reverted_ticks(monkeypatch):
    """Pinned at r8 from t = 0.66 s, the surge's impact on the far wall
    (about 0.77 s) drifts a particle past 0.3 H inside a sticky group: the
    runner reverts and replays at r4, and runner.revert_share reads the
    ticks run less the ticks committed, over the ticks run."""
    res, run = _run(_mix(resort_every=8, max_resort=8, preroll_s=0.68, chunk_dispatches=5),
                    monkeypatch)
    assert res["correct"] is True and res["failed"] == 0, (res["numbers"], res["limits"])
    assert run["ticks_committed"] == 5 * 256
    lost = run["ticks_run"] - run["ticks_committed"]
    assert lost > 0
    share = res["metrics"]["runner.revert_share"]["value"]
    assert share == pytest.approx(100.0 * lost / run["ticks_run"], rel=1e-12)
