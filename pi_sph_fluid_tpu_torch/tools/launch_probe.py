"""What does one kernel launch cost the host?

Every kernel of the port is launched through a Python wrapper (argument
checks, output allocations, a ctypes call).  At 100k particles a tick is
bound by the host, so the wrappers' own time is part of a tick's.  This
probe times each of the five wrappers at the shapes its main path uses
(density, forces and the 64x128 field on one relayout of the 100k pool;
the window copy at L = 2^18 x 64 tiles from odd starts; the span probe's
variant A at the 100k shape): host microseconds per launch with the device
running behind, and CUDA-event ms per launch, whose excess over the
kernel's device time is the host again.

    python -m pi_sph_fluid_tpu_torch.tools.launch_probe
"""

from __future__ import annotations

import json

import torch

from ..ops.window import window_kernels as wk
from ..render import metaballs_window as mw
from ..utils import profiling
from . import span_dma_probe as sp
from . import unaligned_probe as up

__all__ = ["wrapper_calls", "measure", "main"]

G = (0.0, -9.81)
REPS = 200


def wrapper_calls(device, n_pool: int = 100_000) -> dict:
    """{wrapper name: zero-argument call} at the main path's shapes (the
    window kernels on a pool of about ``n_pool`` particles)."""
    eng, fluid = profiling.pool_engine(n_pool, device)
    cfg, spec = eng.cfg, eng.spec
    pk, ctx, _ = eng._relayout(eng._initial_packed(fluid))
    half_dt = eng.half_dt
    geo8, rp = wk.density_window(pk, eng._b_geo_d, ctx.spans, cfg, spec)
    calls = {
        "density_window": lambda: wk.density_window(
            pk, eng._b_geo_d, ctx.spans, cfg, spec),
        "forces_window": lambda: wk.forces_window(
            pk, geo8, rp, eng._b_geo_f, ctx.spans, G, cfg, spec, half_dt, 1.0)}
    rend = mw.WindowRenderer(eng, 64, 128)
    calls["field_window"] = lambda: mw.field_window(
        rend.q_packed, pk, ctx.start_grid, rend.reuse_span_idx, cfg,
        rend.reuse_spec)
    L, n_tiles = up.SHAPES[0]
    src_np, _, un = up.make_starts(L, n_tiles)
    src, starts = torch.from_numpy(src_np).to(device), torch.from_numpy(un).to(device)
    calls["window_copy"] = lambda: up.window_copy(starts, src, aligned=False)
    spans, cap = sp.VARIANTS["A"]
    q, s_src, w_s = sp.make_inputs(*sp.SHAPES[0], spans, cap, device)
    calls["span_density"] = lambda: sp.span_density(q, s_src, w_s, spans, cap)
    return calls


def measure(device, reps: int = REPS) -> dict:
    """{wrapper: {"host_us": .., "event_ms": ..}}; three rounds, the least
    of each (the host's clock is shared and noisy upward)."""
    out = {}
    for name, fn in wrapper_calls(device).items():
        out[name] = dict(
            host_us=min(profiling.host_us(fn, reps) for _ in range(3)),
            event_ms=min(profiling.event_ms(fn, reps) for _ in range(3)))
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("launch_probe: needs a CUDA device")
    out = measure(torch.device("cuda"))
    print(json.dumps({"gpu": torch.cuda.get_device_name(0), **out}), flush=True)
    return out


if __name__ == "__main__":
    main()
