"""Finding a cell's parts by name.

BENCHMARK.json names the cells, the configurations and the metrics; a
configuration's numbers sit in its own file (``configs[].file``), a
traffic mix in ``traffic/<traffic>.json``, an end-to-end metric's reader
in ``end_to_end/<name>.py`` and a per-layer metric's in
``metrics/<name>.py``.  A quantity reported in cells that move different
end-to-end metrics is split by name, ``<quantity>.<part>``, and each part
is read by ``<quantity>.py`` unless it has a module of its own.  Adding a
cell or a metric is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

__all__ = ["Spec"]

HERE = pathlib.Path(__file__).resolve().parent


class Spec:
    """BENCHMARK.json of the checkout at ``root`` and the files it names."""

    def __init__(self, root: pathlib.Path, bench_dir: pathlib.Path = HERE):
        self.root = pathlib.Path(root)
        self.dir = pathlib.Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    @staticmethod
    def _by_name(entries: list, name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._by_name(self.bench["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._by_name(self.bench["configs"], name, "configuration")
        with open(self.root / entry["file"]) as f:
            cfg = json.load(f)
        if cfg.get("name", name) != name:
            raise ValueError(f"{entry['file']} holds {cfg['name']!r}, not {name!r}")
        return cfg

    def traffic(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, cell: dict, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports: those
        that list it under ``workloads``, and those without the key (a
        per-layer metric without it goes with every cell that reports the
        end-to-end metric it moves)."""
        e2e = [m["name"] for m in self.metrics(cell, "end_to_end")] if kind == "per_layer" else []
        out = []
        for m in self.bench[kind]:
            if "workloads" in m:
                if cell["name"] in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def reader(self, kind: str, name: str):
        """The ``read(run)`` function of the metric's own module, or of the
        quantity it is a part of."""
        sub = {"end_to_end": "end_to_end", "per_layer": "metrics"}[kind]
        stem = name
        while not (self.dir / sub / f"{stem}.py").exists() and "." in stem:
            stem = stem.rsplit(".", 1)[0]
        path = self.dir / sub / f"{stem}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{sub}_{stem.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
