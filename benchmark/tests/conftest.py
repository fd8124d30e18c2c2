"""The benchmark's own tests: run from the repository root with
``python -m pytest benchmark/tests``.  They import the benchmark as the
package ``benchmark`` and the port from the checkout."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def quick(traffic: dict) -> dict:
    """A cell's traffic cut to what a CPU test can hold: a short pre-roll,
    chunks of two dispatches and a check of two dispatches.  The limits
    stay the cell's own."""
    t = dict(traffic)
    t.update(preroll_s=0.05, settle_s=0.0, chunk_dispatches=2, trace_s=1.0)
    t["check"] = dict(traffic["check"], dispatches=2)
    return t


def run_mix(config: str, traffic: str, metrics=(), seed: int = 2147483711,
            seconds: float = 0.5, trace: bool = False, control: bool = False, root=ROOT):
    """One run of a configuration under a traffic mix, found by their names
    (a mix no cell names yet included), on the CPU through the harness (the
    plain versions of the port's kernels), reporting the BENCHMARK.json
    entries ``metrics``."""
    import time

    from benchmark import harness
    from benchmark.spec import Spec

    spec = Spec(root, root / "benchmark")
    kind = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: spec.reader(kind, m["name"]) for m in metrics}
    return harness.run_cell(spec.config(config), quick(spec.traffic(traffic)), list(metrics),
                            readers, seed, seconds, trace, "cpu", time.perf_counter(),
                            control=control, log=lambda *a, **k: None)


def run_cpu(workload: str, seed: int = 2147483711, seconds: float = 0.5,
            trace: bool = False, control: bool = False, root=ROOT):
    """One run of a cell on the CPU through the harness, with the cell's metrics."""
    from benchmark.spec import Spec

    spec = Spec(root, root / "benchmark")
    cell = spec.workload(workload)
    metrics = spec.metrics(cell, "per_layer" if trace else "end_to_end")
    return run_mix(cell["config"], cell["traffic"], metrics, seed, seconds, trace, control, root)
