"""The forces kernel against other builds of itself: bitwise outputs, time
a launch and the SM's resources.

Builds the forces kernel of ``csrc/window_kernels.cu`` as it stands, and
beside it each variant asked for: the same source with ``FORCES_U`` (the
lanes a thread tests for reach at once) set to another value
(``--unroll``), or another source of the same entry points (``--against``,
say the file of an earlier commit).  Each goes into a library of its own
and is launched through the port's wrapper (``forces_window``) on three
inputs:

* ``pool_100k``: one relayout of the 100k pool with seeded random
  velocities (chip_smoke.py's kernel phase);
* ``squeezed_20k``: the 20k pool squeezed to 0.6 of its width and height
  at cap 1024, windows of several staged chunks (the ``cap1024_dense``
  case of tests/test_torch_cuda.py::pool_frame);
* ``tank_1m``: the 1M tank (the box's lattice from 2 R off the side walls
  and the floor to 0.85 of its height, 1,066,032 fluid rows, no jitter)
  after its prime and 64 ticks at resort_every 64, relaid out, cap 5248.

For each input and build: whether acc and pk_next equal the first build's
bit for bit, and whether two launches of the build equal each other; the
CUDA-event ms a launch, taken in turns (first build to last and back); the
profiler's device ms a launch; and the input's pairs in reach of its window
lanes.  For each build: ptxas's registers, shared memory and spills of
``forces_window_kernel`` and the blocks of 128 threads (qb = 16) that
those leave resident on an SM.

    python -m pi_sph_fluid_tpu_torch.tools.forces_probe [--unroll 4,8]
        [--against OLD.cu] [--inputs pool_100k,squeezed_20k,tank_1m]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import re
import subprocess

import numpy as np
import torch

from ..config import SPHConfig
from ..models.boundary import prepare_boundary
from ..models.engine_v3 import WindowEngine
from ..models.scene import build_box_boundary, build_fluid
from ..ops.window import _build
from ..ops.window import window_kernels as wk
from ..utils import profiling

__all__ = ["build", "inputs", "resident_blocks", "measure", "main"]

G = (0.0, -9.81)
SOURCE = _build.SOURCES["window_kernels"][0]
ARGTYPES = _build.SOURCES["window_kernels"][1]["forces_window"]
U_LINE = re.compile(r"constexpr int FORCES_U = \d+;")
TANK_R = math.sqrt(6.35 / 1e6)       # benchmark/configs/tank_1m.json's r
TANK_FLUID = 1_066_032
# the H100's SM (CUDA occupancy rules for compute capability 9.0)
SM_REGS, SM_THREADS, SM_BLOCKS = 65_536, 2_048, 32
SM_SMEM, BLOCK_SMEM_RESERVED = 233_472, 1_024
REG_UNIT = 256                       # registers are allocated a warp at a time


def build(name: str, text: str) -> tuple:
    """(the forces entry point, ptxas's {registers, smem, spill_bytes}) of
    the window-kernel source ``text``, built with the port's flags into
    ``build/`` as ``libforces_probe_<name>_<hash>.so``."""
    tag = hashlib.sha256(text.encode() + " ".join(_build.FLAGS).encode()).hexdigest()[:16]
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"forces_probe_{name}_{tag}.cu"
    lib = out_dir / f"libforces_probe_{name}_{tag}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
    fn = ctypes.CDLL(str(lib)).forces_window
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn, _ptxas(log, "forces_window_kernel")


def _ptxas(log: str, kernel: str) -> dict:
    """Registers, static shared memory and spill bytes ptxas reports for the
    entry function whose name holds ``kernel``."""
    out, inside = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and "spill" in line:
            out["spill_bytes"] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif inside and "registers" in line:
            out["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out["smem"] = int(smem.group(1)) if smem else 0
            inside = False
    if "registers" not in out:
        raise RuntimeError(f"ptxas reported nothing for {kernel}:\n{log}")
    return out


def resident_blocks(registers: int, smem: int, threads: int) -> dict:
    """Blocks of ``threads`` threads an H100 SM holds at once, and what
    limits it, from a kernel's registers a thread and static shared memory a
    block."""
    warps = -(-threads // 32)
    warp_regs = -(-registers * 32 // REG_UNIT) * REG_UNIT
    limits = dict(registers=SM_REGS // warp_regs // warps,
                  smem=SM_SMEM // (-(-smem // 128) * 128 + BLOCK_SMEM_RESERVED),
                  threads=SM_THREADS // (warps * 32), blocks=SM_BLOCKS)
    least = min(limits.values())
    return dict(blocks=least, warps=least * warps,
                limited_by=[k for k, v in limits.items() if v == least])


def _tank(device) -> tuple:
    """(WindowEngine, FluidState) of the 1M tank: the box's lattice from 2 R
    off both side walls and the floor up to 0.85 of its height, in float32
    as benchmark/scene.py lays it out (no jitter), at cap 5248."""
    cfg = SPHConfig(r=TANK_R)
    f32 = np.float32
    gap = f32(2.0) * f32(cfg.r)
    x_hi, top = f32(cfg.width) - gap, f32(0.85) * f32(cfg.height)

    def predicate(x, y):
        return (x >= gap) & (x <= x_hi) & (y >= gap) & (y < top)

    fluid = build_fluid(cfg, predicate, device)
    if fluid.n != TANK_FLUID:
        raise RuntimeError(f"tank lattice has {fluid.n} rows, not {TANK_FLUID}")
    b, bg = prepare_boundary(build_box_boundary(cfg, device), cfg)
    return WindowEngine(cfg, b, bg, fluid.n, device, cap=5248), fluid


def _randomised(fluid, squeeze: float, device):
    """The fluid scaled toward the corner by ``squeeze``, with seeded
    N(0, 0.5) m/s velocities so that the viscosity term is live."""
    rng = np.random.default_rng(3)
    return fluid._replace(x=fluid.x * squeeze, y=fluid.y * squeeze, **{
        k: torch.from_numpy(rng.normal(0.0, 0.5, fluid.n).astype(np.float32)).to(device)
        for k in ("u", "v")})


def inputs(name: str, device) -> tuple:
    """(forces_window's arguments, pairs in reach, pairs of the window
    lanes) of input ``name``."""
    if name == "pool_100k":
        eng, fluid = profiling.pool_engine(100_000, device)
        packed = eng._initial_packed(_randomised(fluid, 1.0, device))
    elif name == "squeezed_20k":
        eng, fluid = profiling.pool_engine(20_000, device, cap=1024)
        packed = eng._initial_packed(_randomised(fluid, 0.6, device))
    elif name == "tank_1m":
        eng, fluid = _tank(device)
        sim = eng.prime(fluid, G)
        sim, _ = eng.make_multi_step(resort_every=64)(sim, np.tile(np.float32(G), (64, 1)))
        packed = sim.packed
    else:
        raise ValueError(f"unknown input {name!r}")
    pk, ctx, ov = eng._relayout(packed)
    if int(ov):
        raise RuntimeError(f"{name}: relayout overflow {int(ov)}")
    geo8, rp = wk.density_window(pk, eng._b_geo_d, ctx.spans, eng.cfg, eng.spec)
    args = (pk, geo8, rp, eng._b_geo_f, ctx.spans, G, eng.cfg, eng.spec,
            eng.half_dt, 0.97)
    lanes = int(ctx.spans[:, :, 1].sum(1).clamp_max(eng.spec.cap).sum())
    in_reach = profiling.pairs_in_reach(pk, eng._b_geo_d, ctx.spans, eng.cfg, eng.spec)
    return args, in_reach, eng.spec.qb * lanes


def _launch_with(fn, args) -> tuple:
    """forces_window(*args) through the entry point ``fn``."""
    wk._ENTRIES["forces_window"] = fn
    return wk.forces_window(*args)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def measure(builds: dict, names: list, device, reps: int = 50) -> dict:
    """{input: {pairs, and per build: bitwise, repeatable, event_ms,
    device_ms}} for the entry points ``builds`` (name -> fn), the first
    being the one the others are held against."""
    saved = wk._ENTRIES.get("forces_window")
    order = list(builds)
    out = {}
    try:
        for name in names:
            args, in_reach, pairs = inputs(name, device)
            res = {"pairs_in_reach": in_reach, "pairs": pairs,
                   "in_reach_share": in_reach / pairs}
            ref = [_bits(t) for t in _launch_with(builds[order[0]], args)]
            times = {b: [] for b in order}
            for b in order + order[::-1]:
                fn = builds[b]
                times[b].append(profiling.event_ms(lambda: _launch_with(fn, args), reps))
            for b in order:
                fn = builds[b]
                one = [_bits(t) for t in _launch_with(fn, args)]
                two = [_bits(t) for t in _launch_with(fn, args)]
                torch.cuda.synchronize(device)
                res[b] = dict(
                    bitwise=all(torch.equal(x, y) for x, y in zip(one, ref)),
                    repeatable=all(torch.equal(x, y) for x, y in zip(one, two)),
                    event_ms=sum(times[b]) / len(times[b]),
                    device_ms=profiling.kernel_device_ms(
                        lambda: _launch_with(fn, args), "forces_window_kernel", device))
            out[name] = res
            print(json.dumps({name: res}), flush=True)
    finally:
        if saved is None:
            wk._ENTRIES.pop("forces_window", None)
        else:
            wk._ENTRIES["forces_window"] = saved
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="forces_probe", description=__doc__.split("\n\n")[0])
    ap.add_argument("--unroll", default="", help="comma-separated FORCES_U values to build beside the source's")
    ap.add_argument("--against", default=None, help="another window_kernels.cu to build, held first")
    ap.add_argument("--inputs", default="pool_100k,squeezed_20k,tank_1m")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    device, gpu = profiling.resolve_device("cuda", "forces_probe")
    text = SOURCE.read_text()
    if not U_LINE.search(text):
        raise SystemExit("forces_probe: no FORCES_U line in the source")
    texts = {}
    if args.against:
        with open(args.against) as f:
            texts["against"] = f.read()
    texts["source"] = text
    for u in filter(None, args.unroll.split(",")):
        texts[f"U{int(u)}"] = U_LINE.sub(f"constexpr int FORCES_U = {int(u)};", text)
    builds, ptxas = {}, {}
    for name, t in texts.items():
        builds[name], info = build(name, t)
        ptxas[name] = dict(info, **resident_blocks(info["registers"], info["smem"], 128))
    print(json.dumps({"gpu": gpu, "ptxas": ptxas}), flush=True)
    out = dict(gpu=gpu, ptxas=ptxas,
               **measure(builds, args.inputs.split(","), device, args.reps))
    return out


if __name__ == "__main__":
    main()
