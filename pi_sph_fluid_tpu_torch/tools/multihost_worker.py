"""One process of a ``WindowDomain`` run over several processes (port of
`tools/multihost_worker.py:27-108`).

Started once a process, with the same arguments but ``--process-id``:

    python -m pi_sph_fluid_tpu_torch.tools.multihost_worker --num-processes 2 \\
        --process-id 0 --coordinator file:///tmp/store --slabs-per-process 4 --device cpu

Each process joins the group (parallel/launch.py), holds
``--slabs-per-process`` consecutive slabs of a ``WindowDomain`` over
``DistComm`` and runs the whole decomposition: one exact step (migration
and halo exchange), a sticky run of ``--steps`` ticks at
``--resort-every`` (the carried ticks' halo-row shifts), one 64x128
per-slab frame (the composed field's all-gather) and ``export`` (the
whole state on every process).  The slab edges between processes exchange
over the group, the others inside the process.  Process 0 writes the
exported state and the frame to ``--out``; the same sequence in one
process over ``LocalComm`` must give the same bits.  The scene is the
default dam break (400 particles) at tq=32, qb=8, cap=256, seg_q=2, or with ``--n`` the
pool at about n particles at the engine's defaults.
"""

from __future__ import annotations

import argparse
import math
from types import SimpleNamespace

import numpy as np

from ..config import SPHConfig
from ..models.boundary import prepare_boundary
from ..models.scene import build_dam_break_scene, build_pool_scene
from ..parallel import DistComm, WindowDomain
from ..parallel.launch import init_distributed
from ..render.metaballs import unpack_framebuffer

__all__ = ["build", "run", "main", "FRAME"]

G = (0.0, -9.81)
FRAME = (64, 128)


def build(comm, device, n: int | None = None):
    """(WindowDomain over ``comm``, the global FluidState): the dam at the
    small engine sizes, or the pool at about ``n`` particles."""
    if n is None:
        cfg = SPHConfig()
        fluid, braw = build_dam_break_scene(cfg, device)
        opts = dict(tq=32, qb=8, cap=256, seg_q=2)
    else:
        cfg = SPHConfig(r=math.sqrt(6.35 / n))
        fluid, braw = build_pool_scene(cfg, device)
        opts = {}
    b, bg = prepare_boundary(braw, cfg)
    return WindowDomain(cfg, b, bg, fluid.n, comm, device, **opts), fluid


def run(dd, fluid, steps: int = 8, resort_every: int = 2) -> SimpleNamespace:
    """The sequence, with JAX's checks: one exact step, ``steps`` sticky
    ticks, one frame, the export.  Returns the states after the exact step
    and at the end, the framebuffer (numpy) and the export."""
    g = np.tile(np.float32(G), (steps, 1))
    state0 = dd.init(fluid)
    exact, st = dd.make_step()(state0, G)
    if int(st["n_valid"]) != fluid.n or int(st["overflow"]) != 0:
        raise RuntimeError(f"exact step: n_valid {int(st['n_valid'])} of {fluid.n}, "
                           f"overflow {int(st['overflow'])}")
    if not math.isfinite(float(st["max_speed"])):
        raise RuntimeError("exact step: non-finite max speed")
    state, st = dd.make_multi_step(resort_every=resort_every)(exact, g)
    n_valid = int(st["n_valid"][-1])
    if n_valid != fluid.n or int(st["overflow"].max()) or int(st["stale"].sum()):
        raise RuntimeError(f"sticky run: n_valid {n_valid} of {fluid.n}, overflow "
                           f"{int(st['overflow'].max())}, stale {int(st['stale'].sum())}")
    fb, r_ov = dd.make_render(*FRAME)(state)
    fb = fb.cpu().numpy()
    lit = int(unpack_framebuffer(fb, *FRAME).sum())
    if int(r_ov) != 0 or not 0 < lit < FRAME[0] * FRAME[1]:
        raise RuntimeError(f"frame: overflow {int(r_ov)}, {lit} pixels lit")
    fl, au, av = dd.export(state)
    if fl.n != fluid.n:
        raise RuntimeError(f"export: {fl.n} particles of {fluid.n}")
    return SimpleNamespace(exact=exact, state=state, fb=fb, export=(fl, au, av),
                           n_valid=n_valid)


def save(path: str, res: SimpleNamespace) -> None:
    """The export (every FluidState field, au, av) and the frame as npz."""
    fl, au, av = res.export
    np.savez(path, **{f: getattr(fl, f).cpu().numpy() for f in type(fl)._fields},
             au=au.cpu().numpy(), av=av.cpu().numpy(), fb=res.fb)


def main(argv=None) -> SimpleNamespace:
    """Joins the group, runs the sequence, writes ``--out`` from process 0
    and prints the ``multihost OK`` line; returns the run (with ``dd``,
    ``fluid`` and ``comm``).  The process group stays up for the caller."""
    ap = argparse.ArgumentParser(prog="pi_sph_fluid_tpu_torch.tools.multihost_worker")
    ap.add_argument("--coordinator", required=True,
                    help="process 0's HOST:PORT or a file:// URL")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--slabs-per-process", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="every process's torch device (cuda:N a card each under "
                         "nccl; all on one card: cuda with --backend gloo)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="the transport (default: nccl for cuda, gloo for cpu)")
    ap.add_argument("--resort-every", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--n", type=int, default=None,
                    help="the pool at about n particles instead of the 441 dam")
    ap.add_argument("--out", default=None,
                    help="npz of the exported state and the frame (process 0)")
    args = ap.parse_args(argv)

    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     backend=args.backend, device=args.device)
    comm = DistComm(args.num_processes * args.slabs_per_process)
    dd, fluid = build(comm, args.device, args.n)
    res = run(dd, fluid, args.steps, args.resort_every)
    if args.out and args.process_id == 0:
        save(args.out, res)
    print(f"[proc {args.process_id}] multihost OK: {args.num_processes} procs x "
          f"{args.slabs_per_process} slabs (slabs {comm.slabs.start}-"
          f"{comm.slabs.stop - 1}), n_valid={res.n_valid}, "
          f"staged_bytes={comm.staged_bytes}", flush=True)
    res.dd, res.fluid, res.comm = dd, fluid, comm
    return res


if __name__ == "__main__":
    import torch.distributed as dist

    main()
    dist.destroy_process_group()
