"""Run one cell of BENCHMARK.json on the card and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Without a CUDA card (or with fewer than
the cell asks for) it exits with code 3 and prints no result.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit,
which also close standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache of the run stays inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(ROOT / "build" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "pi_sph_fluid_tpu_torch").is_dir():
        print(f"no pi_sph_fluid_tpu_torch in {ROOT}: nothing to measure", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.spec import Spec

    spec = Spec(ROOT)
    cell = spec.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    from benchmark import harness, roofline

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = spec.metrics(cell, kind)
    readers = {m["name"]: spec.reader(kind, m["name"]) for m in metrics}
    res = harness.run_cell(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                           metrics, readers, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_START, log=print)
    held = sorted({m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))
    if held:
        print(f"the process holds {held} after the window", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": res["peak"],
              "power_limit": roofline.power_limit()}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    check = {k: {"value": res["numbers"].get(k), "limit": lim}
             for k, lim in res["limits"].items()}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["check"] = check
    print(json.dumps(line))
    for k, c in check.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
