"""On the card: a run of `drop_269.still` as the benchmark command starts it, untraced
and traced, ends with a correct result line.  Skips without a card."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_run_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "drop_269.still",
                          "--seed", "2147483723", "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert list(line)[-1] == "check"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "stepper.launches_per_tick" in line["metrics"]
    else:
        assert line["metrics"]["frame_gap_p95_ms"]["value"] > 0
