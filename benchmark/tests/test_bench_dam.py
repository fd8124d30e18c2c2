"""The dam scene: its lattice is the port's ``build_dam_break_scene`` bit for
bit, and a dam cell added by files and entries alone, in a temporary copy
of the benchmark, runs correct through the harness."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import scene
from benchmark.harness import port_config
from benchmark.spec import Spec
from conftest import ROOT
from pi_sph_fluid_tpu_torch.models.scene import build_dam_break_scene


def _dam(fill_x, fill_y):
    cfg = dict(Spec(ROOT).config("drop_269"), scene="dam", fill_x=fill_x, fill_y=fill_y)
    for k in ("drop_radius", "n_fluid"):
        cfg.pop(k)
    return cfg


@pytest.mark.parametrize("fill", [(0.4, 0.8), (0.55, 0.35)])
def test_the_dam_lattice_is_the_ports(fill):
    cfg = _dam(*fill)
    xs = scene.float32_lattice(cfg["width"], cfg["r"])
    ys = scene.float32_lattice(cfg["height"], cfg["r"])
    fx, fy = scene._fluid_lattice(cfg, xs, ys)
    fluid, _ = build_dam_break_scene(port_config(cfg), "cpu", *fill)
    assert fx.dtype == fy.dtype == np.float32 and fx.shape[0] > 0
    assert fx.tobytes() == fluid.x.numpy().tobytes()
    assert fy.tobytes() == fluid.y.numpy().tobytes()


def test_a_dam_cell_added_by_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "pi_sph_fluid_tpu_torch", tmp_path / "pi_sph_fluid_tpu_torch")
    b = tmp_path / "benchmark"
    cfg = dict(_dam(0.4, 0.8), name="dam_400")
    xs = scene.float32_lattice(cfg["width"], cfg["r"])
    ys = scene.float32_lattice(cfg["height"], cfg["r"])
    cfg["n_fluid"] = int(scene._fluid_lattice(cfg, xs, ys)[0].shape[0])
    (b / "configs" / "dam_400.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "drop_269.still.json").read_text())
    traffic["config"] = "dam_400"
    (b / "traffic" / "dam_400.still.json").write_text(json.dumps(traffic))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="dam_400", source="a test",
                                 file="benchmark/configs/dam_400.json", reduced=[], why="a test"))
    bench["workloads"].append(dict(name="dam_400.still", config="dam_400",
                                   traffic="dam_400.still", chips=1, why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] == "particle_steps_per_s":
            m["workloads"].append("dam_400.still")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, pathlib, sys
sys.path.insert(0, {str(tmp_path)!r})
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
import benchmark
assert benchmark.__file__.startswith({str(tmp_path)!r}), benchmark.__file__
from conftest import run_cpu
r = run_cpu("dam_400.still", root=pathlib.Path({str(tmp_path)!r}))
print(json.dumps(dict(correct=r["correct"], metrics=sorted(r["metrics"]),
                      numbers=r["numbers"], checked=r["checked"])))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["checked"] >= 1, out
    assert out["metrics"] == ["particle_steps_per_s", "setup_s"]
