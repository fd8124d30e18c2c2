"""Max speed against the CFL time step on bench.py's pool (port of
`tools/cfl_probe.py`).

At 100k particles (r ~ 0.008) with enough window capacity, max speed still
climbs toward the C/10 = 40 m/s design bound over horizons of ~10k ticks.
The reference's own comment says CFL stability wants DT = 0.4*H/C while it
ships DT = H/C (`pi_sph_fluid.c:19`); this probe runs the same scene at
each ``--factors`` dt factor over the same sim time through
``SimRunner(backend="window", render=False, max_cap=2048)`` (the cap
recovery on) and records the (sim time, rho error, max speed) trajectory
from the runner's 0.1 sim-s report lines: is the growth a dt artifact or
physics?

    python -m pi_sph_fluid_tpu_torch.tools.cfl_probe --n 100000 \\
        --seconds 0.6 --settle 0.3 [--device cuda|cpu]

Dispatches hold ``--dispatch`` ticks (2048, rounded up to the resort
period), so a 0.1 sim-s report comes every few dispatches at 100k; a
smaller scene needs a smaller dispatch to report at all.  ``main`` returns
each factor's trajectory and summary.
"""

from __future__ import annotations

import argparse
import io
import math
import re
import sys

from ..config import SPHConfig
from ..io.gravity import ConstantGravity
from ..io.host_loop import SimRunner
from ..models.scene import build_pool_scene
from ..utils.profiling import resolve_device

REPORT = re.compile(
    r"sim time: ([0-9.]+).*?max rho error: ([0-9.]+)%"
    r".*?max speed: ([0-9.]+) m/s")
SPEED_BOUND = 40.0      # C/10, the WCSPH design bound (m/s)


class _Tee:
    """A report stream that keeps what it is given and echoes it."""

    def __init__(self):
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        sys.stdout.write(s)

    def flush(self):
        sys.stdout.flush()


def run_one(dt_factor: float, args, device) -> dict:
    cfg = SPHConfig(r=math.sqrt(6.35 / args.n), dt_factor=dt_factor)
    fluid, braw = build_pool_scene(cfg, device)
    print(f"dt_factor={dt_factor}: dt={cfg.dt:.3e}  "
          f"steps={int(args.seconds / cfg.dt)}", flush=True)
    runner = SimRunner(cfg, fluid, braw, backend="window",
                       engine_opts=dict(cap=args.cap), render=False,
                       resort_every=args.resort, max_cap=2048, device=device)
    tee = _Tee()
    res = runner.run(ConstantGravity(cfg), None, sim_seconds=args.seconds,
                     settle_seconds=args.settle, steps_per_dispatch=args.dispatch,
                     report_stream=tee)
    rows = [(float(t), float(rho), float(spd))
            for t, rho, spd in REPORT.findall(tee.buf.getvalue())]
    out = dict(n=fluid.n, dt=cfg.dt, steps=res.steps, rows=rows,
               ps_per_s=res.particle_steps_per_s,
               overflow=res.reporter.total_overflow, stale=res.reporter.total_stale,
               recoveries=res.recoveries)
    print(f"  -> {res.steps} steps, {res.particle_steps_per_s / 1e6:.2f}M ps/s, "
          f"overflow {out['overflow']}, {res.recoveries} recoveries", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="cfl_probe")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--seconds", type=float, default=0.6)
    ap.add_argument("--settle", type=float, default=0.3)
    ap.add_argument("--cap", type=int, default=1024)
    ap.add_argument("--resort", type=int, default=4)
    ap.add_argument("--factors", type=str, default="1.0,0.4")
    ap.add_argument("--dispatch", type=int, default=2048,
                    help="ticks a dispatch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device, kind = resolve_device(args.device, "cfl_probe")

    results = {f: run_one(f, args, device)
               for f in (float(s) for s in args.factors.split(","))}
    print("\n=== max-speed trajectories (t, rho_err%, max_speed) ===")
    for f, res in results.items():
        print(f"dt_factor={f}:")
        for t, rho, spd in res["rows"]:
            print(f"  t={t:6.2f}  rho={rho:6.3f}%  speed={spd:7.2f}")
        if res["rows"]:
            res["peak"] = max(r[2] for r in res["rows"])
            res["final"] = res["rows"][-1][2]
            print(f"  peak={res['peak']:.2f} m/s  final={res['final']:.2f} m/s "
                  f"(C/10 bound = {SPEED_BOUND:g})")
    return dict(device=kind, factors=results)


if __name__ == "__main__":
    main()
