"""The readings that the limits of `correct` are set from, on the card.

    python benchmark/control.py --workload <cell> --seeds <n> --first-seed <s>
        --control-seeds <m> --seconds <w> --out <file.jsonl>

For each of ``n`` seeds in one process (set-up is most of a run, and one
process pays the CUDA context once) it runs the cell with a ``w``-second
window and writes one JSON line: the numbers of the program against the
reference (the lower readings), and for the first ``m`` seeds the numbers
of the control against the reference on the same dispatches.  The control
is the reference itself computed in bfloat16, the precision below the
configuration's float32 (reference/sph.py).  The benchmark's own runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness
    from benchmark.spec import Spec

    if not torch.cuda.is_available():
        print("control readings are taken on the card", file=sys.stderr)
        return 3
    spec = Spec(ROOT)
    cell = spec.workload(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    with open(args.out, "a") as out:
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            res = harness.run_cell(cfg, traffic, [], {}, seed, args.seconds, False,
                                   "cuda:0", time.perf_counter(),
                                   control=i < args.control_seeds, log=print)
            line = dict(workload=cell["name"], seed=seed, correct=res["correct"],
                        attempted=res["attempted"], failed=res["failed"],
                        checked=res["checked"], check_s=res["check_s"],
                        numbers=res["numbers"], control=res.get("control"))
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
