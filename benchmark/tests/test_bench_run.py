"""benchmark/run.py as the benchmark command starts it: no result without a card, and
none in a directory that holds only BENCHMARK.json and the benchmark."""

import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

ARGS = ["--workload", "drop_269.still", "--seed", "2147483711", "--seconds", "1", "--trace", "0"]


def _run(cwd, script):
    return subprocess.run([sys.executable, str(script), *ARGS], capture_output=True,
                          text=True, timeout=300, cwd=cwd)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the run without one")
    out = _run(ROOT, ROOT / "benchmark" / "run.py")
    assert out.returncode == 3, out.stderr
    assert out.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, tmp_path / "benchmark" / "run.py")
    assert out.returncode != 0
    assert out.stdout == ""
