"""A cell and a per-layer metric added by files and entries alone, in a
temporary copy of the benchmark: the harness finds them by name."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

METRIC = '''"""dummy.frames: frames the sink took in the traced window."""


def read(run):
    return float(len(run.frame_times))
'''


def test_a_cell_added_by_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "pi_sph_fluid_tpu_torch", tmp_path / "pi_sph_fluid_tpu_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "drop_269.json").read_text())
    cfg["name"] = "dummy"
    (b / "configs" / "dummy.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "drop_269.still.json").read_text())
    traffic["config"] = "dummy"
    (b / "traffic" / "dummy.still.json").write_text(json.dumps(traffic))
    (b / "metrics" / "dummy.frames.py").write_text(METRIC)
    bench["configs"].append(dict(name="dummy", source="a test", file="benchmark/configs/dummy.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="dummy.still", config="dummy", traffic="dummy.still",
                                   chips=1, why="a test"))
    bench["per_layer"].append(dict(name="dummy.frames", unit="frames", better="higher",
                                   source="program_counter", layer="a test",
                                   moves="frame_gap_p95_ms", workloads=["dummy.still"]))
    for m in bench["end_to_end"]:
        if m["name"] == "particle_steps_per_s":
            m["workloads"].append("dummy.still")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, sys
sys.path.insert(0, {str(tmp_path)!r})
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
import benchmark
assert benchmark.__file__.startswith({str(tmp_path)!r}), benchmark.__file__
from conftest import run_cpu
import pathlib
out = {{}}
for trace in (0, 1):
    r = run_cpu("dummy.still", trace=bool(trace), root=pathlib.Path({str(tmp_path)!r}))
    out[trace] = sorted(r["metrics"]), r["correct"]
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    # frame_gap_p95_ms lists its cells and not the new one
    assert out["0"][0] == ["particle_steps_per_s", "setup_s"]
    assert "dummy.frames" in out["1"][0]
