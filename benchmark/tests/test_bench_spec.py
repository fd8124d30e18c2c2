"""BENCHMARK.json against the benchmark's contract, and every cell's parts
found by name."""

import math
import re

import pytest

from benchmark.spec import Spec
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|per_tok")


@pytest.fixture(scope="module")
def spec():
    return Spec(ROOT)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_names(spec):
    b = spec.bench
    assert set(b) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for kind, keys in KEYS.items():
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        names = [e["name"] for e in b[kind]]
        assert len(names) == len(set(names))
        for e in b[kind]:
            assert keys <= set(e) <= keys | extra, (kind, e["name"])
            assert NAME.match(e["name"])
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_command_paths_and_budget(spec):
    b = spec.bench
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for w in b["command"]:
        if w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in b["paths"])
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 * cells runs of rs + 60 s, 2 * 90 s
    # of compile a cell and 1200 s spare, within 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for f in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in f.parts or not f.is_file():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(f.relative_to(ROOT))), f


def test_configs(spec):
    used = {w["config"] for w in spec.bench["workloads"]}
    files = set()
    for c in spec.bench["configs"]:
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = spec.config(c["name"])
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
        assert {"source", "assumed", "reduced"} <= set(cfg)


def test_metrics(spec):
    b = spec.bench
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    perf = (ROOT / "PERF.md").read_text()
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["layer"] in perf, m["layer"]
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            # each cell it lists reports the end-to-end metric it moves
            assert m["moves"] in [x["name"] for x in spec.metrics(spec.workload(w), "end_to_end")]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_and_their_parts_by_name(spec):
    pairs = set()
    four = 0
    for w in spec.bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
        assert traffic["config"] == cfg["name"] == w["config"]
        e2e = spec.metrics(w, "end_to_end")
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        per_layer = spec.metrics(w, "per_layer")
        assert per_layer
        for m in e2e:
            assert callable(spec.reader("end_to_end", m["name"]))
        for m in per_layer:
            assert callable(spec.reader("per_layer", m["name"]))
        for k, lim in traffic["check"]["limits"].items():
            assert math.isfinite(lim) and lim >= 0, (w["name"], k)
    assert four <= max(1, len(spec.bench["workloads"]) // 4)
