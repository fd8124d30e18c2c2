"""Command-line entry points (port of `pi_sph_fluid_tpu/cli.py:127-265`).

``run`` is the interactive simulator (the reference's `desktop_sph_fluid` /
`pi_sph_fluid` targets, `Makefile:18-27`, with --realtime and the sensor
and display chosen at run time); ``bench`` free-runs without pacing.  Both
take ``--backend window`` (the default, the JAX CLI's "pallas": the window
kernels), ``--backend window-dd --slabs N`` (slab domain decomposition, all
N slabs on the one device; the JAX CLI's "pallas-dd") or ``--backend
reference`` (the jnp oracle) on ``--device`` (default ``cuda``; there is no
fallback to the CPU when no GPU is found).  ``--num-processes P
--process-id i --coordinator HOST:PORT`` runs window-dd over P processes
(parallel/launch.py), each holding ``--slabs / P`` slabs; process 0 owns
the display and the printed lines.

    python -m pi_sph_fluid_tpu_torch.cli run --scene drop --seconds 3 --display terminal
    python -m pi_sph_fluid_tpu_torch.cli run --device cpu --scene drop --display file:/tmp/f.bin
    python -m pi_sph_fluid_tpu_torch.cli run --backend window-dd --slabs 4 --scene dam
    python -m pi_sph_fluid_tpu_torch.cli run --backend window-dd --slabs 4 --num-processes 2 \
        --process-id 0 --coordinator 127.0.0.1:29500 --dist-backend gloo --scene dam
    python -m pi_sph_fluid_tpu_torch.cli bench --n 1000000 --steps 64 --render
    python -m pi_sph_fluid_tpu_torch.cli run --backend reference --scene drop --display file:/tmp/f.bin
    python -m pi_sph_fluid_tpu_torch.cli run --scene drop --trace-out /tmp/spans.json
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from .config import SPHConfig
from .models.scene import build_dam_break_scene, build_drop_scene, build_pool_scene
from .utils.tracer import tracer


def _make_scene(args):
    cfg = SPHConfig(r=args.r, dt_factor=args.dt_factor)
    builders = {"drop": build_drop_scene, "dam": build_dam_break_scene,
                "pool": build_pool_scene}
    fluid, braw = builders[args.scene](cfg, args.device)
    return cfg, fluid, braw


def _make_gravity(args, cfg, sink=None):
    from .io.gravity import (ConstantGravity, MPU6050Gravity, RotatingGravity,
                             TraceGravity, WebGravity)

    if args.gravity == "constant":
        return ConstantGravity(cfg)
    if args.gravity == "rotate":
        return RotatingGravity(cfg, period_s=args.rotate_period)
    if args.gravity == "mpu6050":
        return MPU6050Gravity(cfg)
    if args.gravity == "web":
        from .io.web import WebSink

        inner = getattr(sink, "inner", None)   # sinks are AsyncSink-wrapped
        if not isinstance(inner, WebSink):
            raise SystemExit("--gravity web needs --display web "
                             "(the page is the tilt sensor)")
        return WebGravity(cfg, inner)
    if args.gravity.startswith("trace:"):
        import numpy as np

        data = np.load(args.gravity[6:])
        samples = data["samples"] if hasattr(data, "files") else data
        return TraceGravity(samples, sample_hz=args.trace_hz)
    raise SystemExit(f"unknown gravity source {args.gravity!r}")


def _parse_render_shape(s: str) -> tuple[int, int]:
    try:
        rows, cols = (int(v) for v in s.lower().split("x"))
    except ValueError:
        raise SystemExit(f"bad --render-shape {s!r} (want ROWSxCOLS, e.g. 64x128)")
    if rows % 8:
        raise SystemExit("--render-shape rows must be a multiple of 8 "
                         "(page-packed 1-bpp framebuffer)")
    return rows, cols


def _make_sink(args, shape: tuple[int, int]):
    from .io.display import (AsyncSink, FileSink, GifSink, NullSink, PngSink,
                             TerminalSink)

    rows, cols = shape
    if args.display == "none":
        return NullSink()
    if args.display == "terminal":
        return AsyncSink(TerminalSink(rows, cols))
    if args.display.startswith("file:"):
        # no AsyncSink: push is an O(1 KB) buffered append, and a record of
        # the run keeps every frame (one a dispatch, less one a revert)
        return FileSink(args.display[5:])
    if args.display.startswith("png:"):
        return AsyncSink(PngSink(args.display[4:], rows, cols))
    if args.display.startswith("gif:"):
        # no AsyncSink: push is an O(1 KB) append, the encode runs at close
        return GifSink(args.display[4:], rows, cols)
    if args.display.startswith("web"):
        from .io.web import WebSink

        port = int(args.display.split(":")[1]) if ":" in args.display else 8742
        return AsyncSink(WebSink(port, rows, cols))
    if args.display.startswith("ssd1306"):
        from .io.ssd1306 import SSD1306Sink

        bus = int(args.display.split(":")[1]) if ":" in args.display else 1
        return AsyncSink(SSD1306Sink(bus=bus))
    raise SystemExit(f"unknown display {args.display!r}")


def _engine_opts(args) -> dict:
    opts = dict(cap=args.cap)
    if args.backend == "window-dd" and args.slabs:
        opts["slabs"] = args.slabs
    return opts


def _maybe_init_distributed(args) -> bool:
    """Join the process group of a run over several processes before the
    runner is built (`cli.py:103-124`); returns whether this process owns
    the I/O.  Processes above 0 run the same steps and frames (a frame is a
    collective) but display nothing and print no result."""
    if args.num_processes <= 1:
        return True
    if args.coordinator is None:
        raise SystemExit("--num-processes > 1 needs --coordinator HOST:PORT "
                         "(process 0's address) or a file:// URL")
    if args.process_id is None or not 0 <= args.process_id < args.num_processes:
        raise SystemExit("--num-processes > 1 needs --process-id in "
                         f"0..{args.num_processes - 1}")
    if args.backend != "window-dd":
        raise SystemExit("--num-processes > 1 needs --backend window-dd")
    if (args.slabs or 1) % args.num_processes:
        raise SystemExit(f"--slabs {args.slabs or 1} is not a multiple of "
                         f"--num-processes {args.num_processes}")
    if getattr(args, "gravity", "constant") in ("mpu6050", "web"):
        raise SystemExit("--num-processes > 1 needs a gravity source every "
                         "process reads alike (constant, rotate, trace:)")
    from .parallel.launch import init_distributed

    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     backend=args.dist_backend, device=args.device)
    if args.process_id == 0:
        return True
    if getattr(args, "display", "none") != "none":
        print(f"process {args.process_id}: display -> none (process 0 owns "
              f"the display)", file=sys.stderr)
        args.display = "none"
    return False


def cmd_run(args):
    from .io.host_loop import SimRunner

    render = args.display != "none"
    io_owner = _maybe_init_distributed(args)
    cfg, fluid, braw = _make_scene(args)
    loaded = None
    if args.load_state:
        from .state import load_state

        loaded = load_state(args.load_state, args.device)
        fluid = loaded["fluid"]
        if io_owner:
            print(f"resumed {fluid.n} particles from {args.load_state}",
                  file=sys.stderr)
    if io_owner:
        print(f"dt = {cfg.dt:.6f}    (expected ticks/s) {int(1 / cfg.dt)}")
        print(f"n_fluid = {fluid.n}")
        print(f"n_boundary = {braw.n}")
    render_shape = _parse_render_shape(args.render_shape)
    if args.trace_out:
        tracer.enable()
    runner = SimRunner(cfg, fluid, braw, backend=args.backend,
                       engine_opts=_engine_opts(args),
                       render=render,
                       render_shape=render_shape,
                       resort_every=args.resort_every,
                       auto_cap=not args.no_auto_cap,
                       max_cap=args.max_cap,
                       max_resort=args.max_resort or None,
                       device=args.device)
    sink = _make_sink(args, render_shape)
    gravity = _make_gravity(args, cfg, sink)
    # lossless resume (`cli.py:158-178`): the checkpoint carries the raw
    # layout arrays (packed, ids, au, av), written by either package, and
    # the PackedSim is rebuilt verbatim while n_layout still matches; a
    # re-prime from the id-ordered fluid view is only ulp-close
    resume = None
    if loaded is not None and runner.engine is not None and "packed" in loaded:
        pk = loaded["packed"]
        if pk.shape[0] == runner.engine.n_layout:
            from .models.engine_v3 import PackedSim

            resume = PackedSim(packed=pk, ids=loaded["ids"],
                               au=loaded["au"], av=loaded["av"])
        else:
            print(f"layout size changed ({pk.shape[0]} -> "
                  f"{runner.engine.n_layout}): re-priming from the fluid "
                  f"view (ulp-level resume)", file=sys.stderr)
    try:
        result = runner.run(
            gravity, sink, sim_seconds=args.seconds, realtime=args.realtime,
            steps_per_dispatch=args.steps_per_dispatch,
            report_stream=sys.stderr if io_owner else None,
            settle_seconds=args.settle_seconds,
            resume=resume)
    finally:
        sink.close()
        if args.trace_out and io_owner:
            tracer.to_chrome(args.trace_out)
            print(f"{len(tracer.spans)} spans written to {args.trace_out}",
                  file=sys.stderr)
    if args.save_state and runner.domain is not None:
        # a collective: every process gathers, process 0 writes
        fl = runner.domain.gather(result.sim)
        if io_owner:
            from .state import save_state

            save_state(args.save_state, fluid=fl)
            print(f"state saved to {args.save_state}", file=sys.stderr)
    elif args.save_state:
        from .state import save_state

        sim = result.sim
        if runner.engine is not None:
            # the portable id-ordered view plus the raw layout arrays (the
            # leapfrog carry included) for a bitwise resume
            save_state(args.save_state, fluid=runner.engine.unpad(sim),
                       packed=sim.packed, ids=sim.ids, au=sim.au, av=sim.av)
        else:
            save_state(args.save_state, fluid=sim.fluid, ids=sim.ids,
                       au=sim.au, av=sim.av)
        print(f"state saved to {args.save_state}", file=sys.stderr)
    extra = (f", {result.recoveries} capacity recover"
             f"{'y' if result.recoveries == 1 else 'ies'}"
             if result.recoveries else "")
    by = result.reporter.total_overflow_by
    if by is not None and int(by.sum()) > 0:
        from .models.simulation import OVERFLOW_CATEGORIES

        named = {c: int(n) for c, n in zip(OVERFLOW_CATEGORIES, by) if n > 0}
        extra += f", unrecovered overflow by capacity: {named}"
    if io_owner:
        print(f"\n{result.steps} steps in {result.wall_s:.2f}s "
              f"({result.particle_steps_per_s / 1e6:.2f}M particle-steps/s)"
              f"{extra}", file=sys.stderr)
    return result


def cmd_bench(args):
    from .io.gravity import ConstantGravity
    from .io.host_loop import SimRunner

    io_owner = _maybe_init_distributed(args)
    # the pool scene sized to ~n particles (fill area ~6.35 m^2 of the
    # default 4x2 domain)
    cfg = SPHConfig(r=math.sqrt(6.35 / args.n))
    fluid, braw = build_pool_scene(cfg, args.device)
    # auto_cap off: a bench measures the configured cap; overflow shows in
    # the JSON instead
    runner = SimRunner(cfg, fluid, braw, backend=args.backend,
                       engine_opts=_engine_opts(args),
                       render=args.render,
                       resort_every=args.resort_every, auto_cap=False,
                       device=args.device)
    gravity = ConstantGravity(cfg)
    # a warm-up run (the kernels' build and first launches), then the
    # measured one at the same dispatch length
    runner.run(gravity, None, sim_seconds=args.steps * cfg.dt,
               steps_per_dispatch=args.steps)
    result = runner.run(gravity, None, sim_seconds=args.steps * cfg.dt,
                        steps_per_dispatch=args.steps)
    out = {
        "metric": "particle_steps_per_s",
        "value": result.particle_steps_per_s,
        "unit": "particle-steps/s",
        "n_fluid": result.n_fluid,
        "steps": result.steps,
        "wall_s": result.wall_s,
        "backend": args.backend,
        "device": str(runner.device),
        "render": args.render,
        "resort_every": args.resort_every,
        "max_rho_error_pct_worst": result.reporter.worst_rho_error_pct,
        "neighbor_overflow": result.reporter.total_overflow,
        "stale_drift": result.reporter.total_stale,
    }
    if io_owner:
        print(json.dumps(out))
    return out


def _add_target(p):
    p.add_argument("--device", default="cuda",
                   help="torch device the run lives on (cuda, cuda:N, cpu)")
    p.add_argument("--backend", default="window",
                   choices=["window", "window-dd", "reference"],
                   help="window: the window kernels (production); window-dd: "
                        "the window kernels under slab domain decomposition, "
                        "every slab on the one device; reference: the jnp "
                        "oracle (dense candidates, exact every tick, no cap "
                        "recovery)")
    p.add_argument("--slabs", type=int, default=None,
                   help="window-dd: the number of slabs (default 1), a "
                        "multiple of --num-processes")
    p.add_argument("--num-processes", type=int, default=1,
                   help="window-dd over this many processes, each holding "
                        "--slabs / P slabs; every process runs the same "
                        "command but for --process-id")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index, 0..num-processes-1 (0 owns "
                        "the display and the printed result)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process 0's rendezvous address (tcp), or a "
                        "file:// URL every process can reach")
    p.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                   help="the transport between processes (default: nccl "
                        "for a CUDA --device, one card a process, each "
                        "passing its own cuda:N; gloo for cpu).  Several "
                        "processes on one card all pass --device cuda and "
                        "--dist-backend gloo, which stages every exchanged "
                        "buffer through host memory; NCCL refuses two "
                        "processes on one card")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pi_sph_fluid_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="interactive simulation")
    _add_target(rp)
    rp.add_argument("--scene", default="drop", choices=["drop", "dam", "pool"])
    rp.add_argument("--r", type=float, default=0.075, help="particle spacing (m)")
    rp.add_argument("--dt-factor", type=float, default=1.0,
                    help="DT = dt_factor * H / C.  The reference runs 1.0 "
                         "but its own CFL note says 0.4 (`pi_sph_fluid.c:19`)"
                         "; use 0.4 for long-horizon fine-resolution scenes")
    rp.add_argument("--seconds", type=float, default=2.0, help="sim seconds")
    rp.add_argument("--display", default="terminal",
                    help="terminal | none | file:<path> | png:<prefix> "
                         "| gif:<path> (record the run as one looping GIF) "
                         "| web[:port] (live browser view) | ssd1306[:bus]")
    rp.add_argument("--gravity", default="constant",
                    help="constant | rotate | mpu6050 | web (browser tilt "
                         "via the web display's page) | trace:<file.np[z]> "
                         "(a recorded (T,2) accelerometer session)")
    rp.add_argument("--trace-hz", type=float, default=10.0,
                    help="sample rate of a replayed gravity trace")
    rp.add_argument("--rotate-period", type=float, default=4.0)
    rp.add_argument("--render-shape", default="64x128", metavar="ROWSxCOLS",
                    help="framebuffer geometry (rows must be a multiple of "
                         "8); the sink unpacks with the same shape")
    rp.add_argument("--realtime", action="store_true",
                    help="pace to wall-clock like the reference REALTIME mode")
    rp.add_argument("--steps-per-dispatch", type=int, default=None,
                    help="steps per device dispatch (default: one display "
                         "frame's worth, or a report interval headless)")
    rp.add_argument("--settle-seconds", type=float, default=0.0,
                    help="damped pre-roll to bleed off the startup transient "
                         "(recommended >= 0.3 for fine resolutions)")
    rp.add_argument("--cap", type=int, default=384,
                    help="candidate-window lane capacity (overflow is "
                         "counted, never silent)")
    rp.add_argument("--max-cap", type=int, default=1024,
                    help="elastic-capacity ceiling: on window overflow the "
                         "runner grows cap 1.5x and replays the dirty "
                         "interval from the last clean report, up to this cap")
    rp.add_argument("--no-auto-cap", action="store_true",
                    help="disable elastic capacity recovery; overflow is "
                         "still counted and reported")
    rp.add_argument("--resort-every", type=int, default=8,
                    help="sticky-layout interval: relayout every k steps, "
                         "guarded at run time (a drift past 0.3*H halves k "
                         "and replays).  1 = exact per-step relayout")
    rp.add_argument("--max-resort", type=int, default=64,
                    help="upward resort ladder ceiling: after 2 clean report "
                         "intervals the runner doubles resort_every up to "
                         "this value.  0 = off; ignored under --realtime")
    rp.add_argument("--save-state", default=None, metavar="F.npz",
                    help="checkpoint the final state (id-ordered fluid plus "
                         "the raw layout arrays)")
    rp.add_argument("--load-state", default=None, metavar="F.npz",
                    help="start from a checkpoint written by either package")
    rp.add_argument("--trace-out", default=None, metavar="F.json",
                    help="record the run's spans (utils/tracer.py) and write "
                         "them as one Chrome trace-event file at the end "
                         "(process 0 of a multi-process run)")
    rp.set_defaults(fn=cmd_run)

    bp = sub.add_parser("bench", help="headless throughput benchmark")
    _add_target(bp)
    bp.add_argument("--n", type=int, default=1_000_000, help="target particle count")
    bp.add_argument("--steps", type=int, default=200)
    bp.add_argument("--render", action="store_true", help="include rendering in the loop")
    bp.add_argument("--cap", type=int, default=256)
    bp.add_argument("--resort-every", type=int, default=8)
    bp.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    finally:
        import torch.distributed as dist

        if args.num_processes > 1 and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
