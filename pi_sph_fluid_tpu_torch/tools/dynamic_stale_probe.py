"""Does the guarded sticky layout hold on a dynamic scene?  (Port of
`tools/dynamic_stale_probe.py`.)

The bench rides a sticky layout on the settled pool, where drift is tiny
and the 0.3*H drift guard reads 0.  This probe runs the violent scene, the
dam break at ``--n`` particles (r = sqrt(2.56 / n), the fill's area), in
this order:

1. prime, then ``--settle`` damped ticks (damping 0.995) at resort_every
   4, past the first-contact shock;
2. an undamped pre-roll of ``--preroll-s`` sim-seconds into the collapse
   surge (the guard's worst case), in dispatches of 2048 ticks, rounded up
   to whole dispatches; a dispatch is the report cadence: its stats are
   read once, at its end, and the last one's are printed;
3. each resort period of ``--resorts`` from that same surge state: one
   untimed group, then ``--steps`` ticks (rounded up to whole groups)
   timed by the host clock between two synchronisations of the device.

Per period it reports particle-steps a second, ms a step, the guard's
summed ``stale`` count, the largest overflow and the largest max_speed.  A
nonzero stale count is not an error: it is the guard doing its job
(SimRunner's stale downgrade would react); what the probe finds is where
the envelope sits on real motion.

``--backend window`` runs the single ``WindowEngine``; ``--backend
window-dd`` runs the same surge through ``WindowDomain`` over
``LocalComm(--slabs)`` (the same 0.3*H guard over owned rows and ghosts,
with the carried halo), and adds ``n_valid``:

    python -m pi_sph_fluid_tpu_torch.tools.dynamic_stale_probe \\
        [--backend window|window-dd] [--slabs 1] [--device cuda|cpu]

``build(args, device)``, ``surge(...)`` and ``preroll_ticks(args, cfg)``
give another program the same surge state.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..config import SPHConfig
from ..models.boundary import prepare_boundary
from ..models.engine_v3 import WindowEngine
from ..models.scene import build_dam_break_scene
from ..parallel import LocalComm, WindowDomain
from ..utils.profiling import resolve_device, timed

G = (0.0, -9.81)
DISPATCH = 2048         # pre-roll ticks a dispatch: the report cadence
SETTLE_RESORT, SETTLE_DAMPING = 4, 0.995


def _gravity(n: int) -> np.ndarray:
    return np.tile(np.float32(G), (n, 1))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="dynamic_stale_probe")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--settle", type=int, default=1024,
                    help="damped ticks first (the first-contact shock); a "
                         "multiple of 4")
    ap.add_argument("--preroll-s", type=float, default=0.10,
                    help="undamped sim-seconds into the collapse surge before "
                         "measuring (the guard's worst case); 0 for none")
    ap.add_argument("--cap", type=int, default=1024)
    ap.add_argument("--tq", type=int, default=256, help="query rows a tile")
    ap.add_argument("--qb", type=int, default=16, help="query rows a block")
    ap.add_argument("--dt-factor", type=float, default=0.4,
                    help="CFL dt factor (fine resolutions need 0.4)")
    ap.add_argument("--resorts", type=str, default="4,8,16,32")
    ap.add_argument("--backend", default="window", choices=["window", "window-dd"])
    ap.add_argument("--slabs", type=int, default=1,
                    help="window-dd: slabs, all on the one device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.settle % SETTLE_RESORT:
        raise SystemExit(f"--settle must be a multiple of {SETTLE_RESORT}")
    return args


def preroll_ticks(args, cfg: SPHConfig) -> int:
    """``--preroll-s`` in ticks, rounded up to whole dispatches."""
    return -(-int(args.preroll_s / float(cfg.dt)) // DISPATCH) * DISPATCH


def build(args, device):
    """(cfg, fluid, engine or domain, primed state, ``multi_of``) for the
    dam break.  ``multi_of(k, damping=1.0)`` is a multi-step at resort
    period k whose stats are a dict of (K,) device tensors ``max_speed``,
    ``overflow``, ``stale`` (zeros at k = 1) and, for the domain,
    ``n_valid``."""
    cfg = SPHConfig(r=math.sqrt(2.56 / args.n), dt_factor=args.dt_factor)
    fluid, braw = build_dam_break_scene(cfg, device)
    boundary, bgrid = prepare_boundary(braw, cfg)
    if args.backend == "window-dd":
        dd = WindowDomain(cfg, boundary, bgrid, fluid.n, LocalComm(args.slabs),
                          device, tq=args.tq, qb=args.qb, cap=args.cap)

        def multi_of(k: int, damping: float = 1.0):
            multi = dd.make_multi_step(resort_every=k, damping=damping)

            def run(state, g):
                state, st = multi(state, g)
                if "stale" not in st:
                    st["stale"] = torch.zeros_like(st["overflow"])
                return state, st

            return run

        return cfg, fluid, dd, dd.init(fluid), multi_of

    eng = WindowEngine(cfg, boundary, bgrid, fluid.n, device, tq=args.tq,
                       qb=args.qb, cap=args.cap)

    def multi_of(k: int, damping: float = 1.0):
        multi = eng.make_multi_step(damping=damping, resort_every=k)

        def run(sim, g):
            sim, st = multi(sim, g)
            ov = st.neighbor_overflow
            return sim, dict(max_speed=st.max_speed, overflow=ov,
                             stale=torch.zeros_like(ov) if st.stale is None else st.stale)

        return run

    return cfg, fluid, eng, eng.prime(fluid, G), multi_of


def surge(state, multi_of, settle: int, n_pre: int):
    """The damped settle, then ``n_pre`` undamped ticks in dispatches of
    DISPATCH, at resort_every 4: (surge state, the last dispatch's stats
    or None)."""
    state, _ = multi_of(SETTLE_RESORT, SETTLE_DAMPING)(state, _gravity(settle))
    free, st = multi_of(SETTLE_RESORT), None
    for _ in range(n_pre // DISPATCH):
        state, st = free(state, _gravity(DISPATCH))
    return state, st


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, kind = resolve_device(args.device, "dynamic_stale_probe")
    cfg, fluid, _, state, multi_of = build(args, device)
    dd = args.backend == "window-dd"
    print(f"n={fluid.n} dam-break {args.backend}"
          + (f" slabs={args.slabs}" if dd else "")
          + f" on {kind} r={cfg.r:.4g} dt={cfg.dt:.3e} cap={args.cap}", flush=True)
    n_pre = preroll_ticks(args, cfg)
    state, stp = surge(state, multi_of, args.settle, n_pre)
    out = dict(device=kind, backend=args.backend, n=fluid.n, dt=cfg.dt,
               cap=args.cap, preroll_ticks=n_pre)
    if stp is not None:
        pre = dict(t=n_pre * float(cfg.dt), max_speed=float(stp["max_speed"].max()),
                   overflow=int(stp["overflow"].max()))
        if dd:
            pre["n_valid"] = int(stp["n_valid"][-1])
        out["preroll"] = pre
        print(f"pre-roll to t={pre['t']:.3f} sim-s: max_speed={pre['max_speed']:.2f} "
              f"m/s overflow={pre['overflow']}"
              + (f" n_valid={pre['n_valid']}" if dd else "") + " (surge state)",
              flush=True)

    for k in (int(s) for s in args.resorts.split(",")):
        steps = -(-args.steps // k) * k
        multi = multi_of(k)
        multi(state, _gravity(k))                     # untimed: one group
        (_, st), wall = timed(lambda: multi(state, _gravity(steps)), device)
        row = dict(steps=steps, ps_per_s=fluid.n * steps / wall,
                   ms_per_step=wall / steps * 1e3,
                   stale=int(st["stale"].sum()), overflow=int(st["overflow"].max()),
                   max_speed=float(st["max_speed"].max()))
        if dd:
            row["n_valid"] = int(st["n_valid"][-1])
        print(f"resort={k:3d}: {row['ps_per_s'] / 1e6:8.2f} M ps/s  "
              f"({row['ms_per_step']:6.3f} ms/step)  stale={row['stale']}  "
              f"overflow={row['overflow']}  max_speed={row['max_speed']:.1f}"
              + (f"  n_valid={row['n_valid']}" if dd else ""), flush=True)
        out[f"r{k}"] = row
    return out


if __name__ == "__main__":
    main()
