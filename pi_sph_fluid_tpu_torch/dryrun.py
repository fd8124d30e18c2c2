"""Entry points that check the port end to end at small sizes (the
counterpart of the repository's `__graft_entry__.py`).

* ``entry(device)``: one tick of the drop through ``WindowEngine`` on
  ``device``, as ``(fn, args)`` with ``fn(*args) -> (sim, stats)``; on the
  CPU the kernels' plain versions run;
* ``dryrun_multislab(n, device)``: n slabs in this process: the oracle
  ``DomainDecomposition``, ``WindowDomain`` exact and sticky, the export
  into a domain with grown capacities, the per-slab render;
* ``dryrun_multiprocess(n_processes, slabs_per_process, device)``: the
  worker (tools/multihost_worker.py) started as that many processes.

    python -m pi_sph_fluid_tpu_torch.dryrun [cuda|cpu]
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

from .config import SPHConfig
from .models.boundary import prepare_boundary
from .models.engine_v3 import WindowEngine
from .models.scene import build_dam_break_scene, build_drop_scene, build_pool_scene
from .parallel import DomainDecomposition, LocalComm, WindowDomain
from .render.metaballs import unpack_framebuffer

__all__ = ["entry", "dryrun_multislab", "dryrun_multiprocess"]

G = (0.0, -9.81)
SMALL = dict(tq=32, qb=8, cap=256, seg_q=2)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def entry(device="cuda"):
    """-> (fn, (sim, g)): one tick of the drop scene through the window
    engine on ``device`` (`__graft_entry__.py:32-56`)."""
    cfg = SPHConfig()
    fluid, braw = build_drop_scene(cfg, device)
    b, bg = prepare_boundary(braw, cfg)
    eng = WindowEngine(cfg, b, bg, fluid.n, device, **SMALL)
    return eng.make_step(), (eng.prime(fluid, G), G)


def _dryrun_scene(n_slabs: int, device):
    """(cfg, fluid, raw boundary) for an n-slab check (`__graft_entry__.py:
    59-76`): the default dam up to 8 slabs; past that a wide shallow pool,
    since a slab needs at least 6 owned columns (twice the 3-cell halo):
    the same cell, the width 6 columns a slab plus 2, the height halved."""
    if n_slabs <= 8:
        cfg = SPHConfig()
        fluid, braw = build_dam_break_scene(cfg, device)
    else:
        cell = SPHConfig().cell_length
        cfg = SPHConfig(width=(6 * n_slabs + 2) * cell, height=1.0)
        fluid, braw = build_pool_scene(cfg, device, fill_y=0.5)
    return cfg, fluid, braw


def dryrun_multislab(n_slabs: int, device="cuda") -> None:
    """One step of every decomposed path over ``n_slabs`` slabs in this
    process (`__graft_entry__.py:79-164`); raises on a lost particle, an
    overflow, a resumed run off the original, or an unlit frame."""
    cfg, fluid, braw = _dryrun_scene(n_slabs, device)
    b, bg = prepare_boundary(braw, cfg)
    comm = LocalComm(n_slabs)

    dd = DomainDecomposition(cfg, b, bg, fluid.n, comm, device)
    _, st = dd.make_step()(dd.init(fluid), G)
    _require(int(st["n_valid"]) == fluid.n and np.isfinite(float(st["max_speed"])),
             f"oracle DD: {int(st['n_valid'])} of {fluid.n} particles")

    wdd = WindowDomain(cfg, b, bg, fluid.n, comm, device, **SMALL)
    wstep = wdd.make_step()
    state, st = wstep(wdd.init(fluid), G)
    _require(int(st["n_valid"]) == fluid.n and int(st["overflow"]) == 0
             and np.isfinite(float(st["max_speed"])),
             f"window DD: {int(st['n_valid'])} of {fluid.n}, overflow {int(st['overflow'])}")

    state2, st = wdd.make_multi_step(resort_every=2)(state, np.tile(np.float32(G), (4, 1)))
    _require(int(st["n_valid"][-1]) == fluid.n and int(st["overflow"].max()) == 0
             and bool(torch.isfinite(state2.fluid.x).all()),
             f"sticky DD: {int(st['n_valid'][-1])} of {fluid.n}")

    # the recovery rebuild: the lossless export into grown capacities
    # resumes what the original domain steps
    grown = WindowDomain(cfg, b, bg, fluid.n, comm, device,
                         slab_cap=wdd.slab_cap + 128, halo_cap=wdd.halo_cap + 64,
                         mig_cap=wdd.mig_cap + 64, **dict(SMALL, cap=384))
    got = grown.export(grown.make_step()(grown.init(*wdd.export(state2)), G)[0])[0]
    want = wdd.export(wstep(state2, G)[0])[0]
    dx, du = (float((p - q).abs().max()) for p, q in ((got.x, want.x), (got.u, want.u)))
    _require(got.n == fluid.n and dx <= 1e-6 and du <= 1e-5,
             f"resumed into grown capacities: |dx| {dx}, |du| {du}")

    fb, r_ov = wdd.make_render(64, 128)(state2)
    lit = int(unpack_framebuffer(fb.cpu().numpy()).sum())
    _require(int(r_ov) == 0 and 0 < lit < 64 * 128,
             f"render: overflow {int(r_ov)}, {lit} pixels lit")


def dryrun_multiprocess(n_processes: int = 2, slabs_per_process: int = 4,
                        device="cuda", backend: str | None = None,
                        timeout: float = 600) -> None:
    """The worker started as ``n_processes`` processes, joined through a
    file store in a temporary directory (`__graft_entry__.py:167-206`);
    raises unless every one exits 0 with its ``multihost OK`` line.  Every
    process runs on ``device``; under NCCL (``backend`` None on a CUDA
    device) a bare ``cuda`` becomes ``cuda:i`` for process i, one card a
    process, and several processes on one card pass ``backend="gloo"``."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    nccl = backend == "nccl" or (backend is None and torch.device(device).type == "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i in range(n_processes):
            dev = f"cuda:{i}" if nccl and str(device) == "cuda" else str(device)
            cmd = [sys.executable, "-m", "pi_sph_fluid_tpu_torch.tools.multihost_worker",
                   "--coordinator", pathlib.Path(tmp, "store").as_uri(),
                   "--num-processes", str(n_processes), "--process-id", str(i),
                   "--slabs-per-process", str(slabs_per_process), "--device", dev]
            if backend:
                cmd += ["--backend", backend]
            procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "multihost OK" not in out:
            raise RuntimeError(f"worker {i} exited {p.returncode}:\n{out[-4000:]}")


if __name__ == "__main__":
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    fn, args = entry(dev)
    fn(*args)
    print("entry() step OK on", dev)
    dryrun_multislab(8, dev)
    print("dryrun_multislab(8) OK")
    dryrun_multiprocess(device=dev, backend="gloo")
    print("dryrun_multiprocess OK")
