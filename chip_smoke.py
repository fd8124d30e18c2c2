#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pi_sph_fluid_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line with its seconds:

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build: nvcc compiles the window kernels from the checkout's sources;
3. kernels against their plain PyTorch versions on one relayout of the
   100k pool, with times for both;
4. the 100k pool (bench.py's operating point) through WindowEngine: prime,
   64 ticks at resort_every=1, 384 ticks at resort_every=64; the launch
   counters must grow by exactly one per tick; the plain path's ms/tick on
   a short run beside the kernel path's;
5. the 3k-particle C golden drop, all 2000 steps through the kernels;
6. the 1M pool: 64 ticks at resort_every=64.

Then one JSON line that holds every kernel's results, the nvidia-smi
line, and last ``{"ok": true, "device": {...}}``.  Any failure raises and
the exit code is nonzero; without a CUDA device the script fails before
any result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import pi_sph_fluid_tpu_torch as T  # noqa: E402
from pi_sph_fluid_tpu_torch.models import engine_v3  # noqa: E402
from pi_sph_fluid_tpu_torch.ops.window import _build  # noqa: E402
from pi_sph_fluid_tpu_torch.ops.window import window_kernels as wk  # noqa: E402
from pi_sph_fluid_tpu_torch.utils.profiling import pool_engine  # noqa: E402

G = (0.0, -9.81)
DEV = torch.device("cuda")
N_POOL = 100_000        # bench.py:57-66
N_BIG = 1_000_000       # bench.py:149-169
GOLDEN_STEPS = 2000     # the whole 3k C golden
N_WARM, N_R1, N_R64, N_PLAIN = 8, 64, 384, 16
# wrapper (with its launch counter) and the TPU kernel it replaces
KERNELS = {
    "density_window": (wk.density_window,
                       "pi_sph_fluid_tpu/ops/pallas/window_kernels.py:192"),
    "forces_window": (wk.forces_window,
                      "pi_sph_fluid_tpu/ops/pallas/window_kernels.py:317"),
}


def _phase(name: str, t0: float, **info) -> None:
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{name}] {time.perf_counter() - t0:.2f}s {fields}", flush=True)


def _sync() -> None:
    torch.cuda.synchronize(DEV)


def _ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls after one warm-up,
    by CUDA events."""
    fn()
    _sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _reset_counts() -> None:
    for wrapper, _ in KERNELS.values():
        wrapper.launches = 0


def _counts() -> dict:
    return {name: k[0].launches for name, k in KERNELS.items()}


def _gravity(n: int) -> np.ndarray:
    return np.tile(np.float32(G), (n, 1))


def _check_state(sim, stats, what: str) -> None:
    ov = int(stats.neighbor_overflow.max())
    assert ov == 0, f"{what}: neighbor overflow {ov}"
    if stats.stale is not None:
        assert int(stats.stale.sum()) == 0, f"{what}: stale {int(stats.stale.sum())}"
    assert bool(torch.isfinite(sim.packed).all()), f"{what}: non-finite state"
    speed = float(stats.max_speed.max())
    assert speed < 40.0, f"{what}: max speed {speed} m/s breaks the C/10 bound"


def compare_kernels(eng, fluid, results: dict) -> None:
    """Each kernel against its plain version on one relayout of the pool,
    with seeded random velocities (N(0, 0.5) m/s) so that the viscosity
    term is live, and a nonzero half-kick and damping so that the fused
    epilogue is too.  Tolerances (tests/test_torch_window.py): rho rtol
    1e-6; p rtol 1e-4 / atol 0.05 plus rho's tolerance carried through the
    Tait power; acc rtol 2e-5 / atol 2e-4; u' and v' within half_dt times
    the acc bound plus 2 ulp; every copied column bitwise.  The sums run in
    another order (warp-strided lanes and a shuffle tree against torch's
    reduction) and nvcc contracts a*b + c into FMAs; nothing else differs."""
    cfg, spec = eng.cfg, eng.spec
    rng = np.random.default_rng(3)
    fluid = fluid._replace(**{
        k: torch.from_numpy(rng.normal(0.0, 0.5, fluid.n).astype(np.float32)).to(DEV)
        for k in ("u", "v")})
    pk, ctx, ov = eng._relayout(eng._initial_packed(fluid))
    assert int(ov) == 0, f"relayout overflow {int(ov)}"
    trip = ctx.trip_src.long()
    geo_d = torch.cat([torch.cat([pk[:, [0, 1, 4]], torch.zeros_like(pk[:, :1])], 1),
                       eng._tail_d]).index_select(0, trip)
    d_args = (pk, geo_d, ctx.w_start, ctx.flen, cfg, spec)
    g8k, rpk = wk.density_window(*d_args)
    g8p, rpp = wk.density_window_plain(*d_args)
    _sync()
    rho_k, rho_p = rpk[:, 0].double(), rpp[:, 0].double()
    rel_rho = float(((rho_k - rho_p).abs() / rho_p.abs().clamp_min(1e-30)).max())
    assert rel_rho <= 1e-6, f"density: max rel d_rho {rel_rho}"
    p_cond = 7.0 * cfg.tait_b * (rho_p / cfg.rho_0) ** 7 * 1e-6
    dp = (rpk[:, 1].double() - rpp[:, 1].double()).abs()
    assert bool((dp <= 0.05 + 1e-4 * rpp[:, 1].double().abs() + p_cond).all()), \
        f"density: max |d_p| {float(dp.max())}"
    assert torch.equal(g8k[:, [0, 1, 2, 3, 4, 7]], g8p[:, [0, 1, 2, 3, 4, 7]])

    geo_f = torch.cat([g8p, eng._tail_f]).index_select(0, trip)
    f_args = (pk, g8p, rpp, geo_f, ctx.w_start, ctx.flen, G, cfg, spec,
              eng.half_dt, 0.97)
    pkk, acck = wk.forces_window(*f_args)
    pkp, accp = wk.forces_window_plain(*f_args)
    _sync()
    dacc = (acck - accp).abs()
    assert bool((dacc <= 2e-4 + 2e-5 * accp.abs()).all()), \
        f"forces: max |d_acc| {float(dacc.max())}"
    uv_k, uv_p = pkk[:, 2:4], pkp[:, 2:4]
    uv_bound = (eng.half_dt * (2e-4 + 2e-5 * accp.abs())
                + 2 * torch.finfo(torch.float32).eps * uv_p.abs())
    duv = (uv_k - uv_p).abs()
    assert bool((duv <= uv_bound).all()), f"forces: max |d_uv| {float(duv.max())}"
    assert torch.equal(pkk[:, [0, 1, 4, 5, 6, 7]], pkp[:, [0, 1, 4, 5, 6, 7]]), \
        "forces: a copied pk_next column differs"
    pk0, _ = wk.forces_window(pk, g8p, rpp, geo_f, ctx.w_start, ctx.flen, G,
                              cfg, spec, 0.0, 1.0)
    assert torch.equal(pk0[:, 2:4], pk[:, 2:4]), "priming pass moved u, v"

    results["density_window"].update(
        max_abs_err=float((rho_k - rho_p).abs().max()),
        ms=_ms(lambda: wk.density_window(*d_args), 50),
        plain_ms=_ms(lambda: wk.density_window_plain(*d_args), 5))
    results["forces_window"].update(
        max_abs_err=float(dacc.max()),
        ms=_ms(lambda: wk.forces_window(*f_args), 50),
        plain_ms=_ms(lambda: wk.forces_window_plain(*f_args), 5))
    print(f"  density: max rel d_rho {rel_rho:.3e}, max |d_p| {float(dp.max()):.3e} Pa; "
          f"kernel {results['density_window']['ms']:.4f} ms, "
          f"plain {results['density_window']['plain_ms']:.4f} ms", flush=True)
    print(f"  forces: max |d_acc| {float(dacc.max()):.3e} m/s^2, "
          f"max |d_uv| {float(duv.max()):.3e} m/s; "
          f"kernel {results['forces_window']['ms']:.4f} ms, "
          f"plain {results['forces_window']['plain_ms']:.4f} ms", flush=True)


def run_pool(eng, fluid) -> dict:
    """The main path: prime, warm-up ticks, N_R1 exact ticks and N_R64
    sticky ticks (each from the primed state, as bench.py runs them), with
    the launch counters checked per tick."""
    _reset_counts()
    sim0 = eng.prime(fluid, G)
    step = eng.make_multi_step(resort_every=1)
    sticky = eng.make_multi_step(resort_every=64)
    step(sim0, _gravity(N_WARM))
    out = {}
    for name, multi, n in (("r1", step, N_R1), ("r64", sticky, N_R64)):
        _sync()
        t0 = time.perf_counter()
        sim, st = multi(sim0, _gravity(n))
        _sync()
        wall = time.perf_counter() - t0
        _check_state(sim, st, name)
        out[f"{name}_ps_per_s"] = fluid.n * n / wall
        out[f"{name}_ms_per_tick"] = wall / n * 1e3
    counts = _counts()
    ticks = 1 + N_WARM + N_R1 + N_R64
    assert all(c == ticks for c in counts.values()), \
        f"launch counts {counts}, expected {ticks} each (one per tick)"
    out["launches"] = counts
    # the same ticks through the plain versions, for comparison only
    with mock.patch.object(engine_v3, "density_window", wk.density_window_plain), \
            mock.patch.object(engine_v3, "forces_window", wk.forces_window_plain):
        step(sim0, _gravity(1))
        _sync()
        t0 = time.perf_counter()
        step(sim0, _gravity(N_PLAIN))
        _sync()
        out["plain_r1_ms_per_tick"] = (time.perf_counter() - t0) / N_PLAIN * 1e3
    return out


def run_golden() -> dict:
    """The 3k C golden drop through the kernels at the gates of
    tests/test_parity_3k.py:129 (cap=384, as the JAX engine's gate)."""
    golden = np.load(HERE / "tests" / "fixtures" / "golden_drop_3k.npz")
    cfg = T.SPHConfig(r=0.0226)
    fluid, braw = T.build_drop_scene(cfg, DEV)
    assert fluid.n == int(golden["n_fluid"]) == 3021
    b, bg = T.prepare_boundary(braw, cfg)
    eng = T.WindowEngine(cfg, b, bg, fluid.n, DEV, cap=384)
    sim = eng.prime(fluid, G)
    multi = eng.make_multi_step()
    gates = {500: (3e-6, 5e-4), 1000: (1e-5, 5e-4), 2000: (5e-5, 2e-3)}
    worst = {}
    for k in range(1, GOLDEN_STEPS // 100 + 1):
        sim, st = multi(sim, _gravity(100))
        assert int(st.neighbor_overflow.max()) == 0, "3k: window overflow"
        step = k * 100
        if step not in gates:
            continue
        pos_tol, vel_tol = gates[step]
        assert int(golden["steps"][k]) == step
        gs = golden["states"][k]
        ours = eng.unpad(sim)
        err = {f: float(np.abs(getattr(ours, f).cpu().numpy() - gs[:, i]).max())
               for i, f in enumerate("xyuv")}
        rho_rel = float((np.abs(ours.rho.cpu().numpy() - gs[:, 5]) / gs[:, 5]).max())
        assert max(err["x"], err["y"]) <= pos_tol, f"3k step {step}: {err}"
        assert max(err["u"], err["v"]) <= vel_tol, f"3k step {step}: {err}"
        assert rho_rel <= 3e-4, f"3k step {step}: rho rel {rho_rel}"
        worst[step] = dict(err, rho_rel=rho_rel)
    return worst


def run() -> dict:
    """Phases 2-6 on the card; returns the per-kernel results."""
    t0 = time.perf_counter()
    _, log = _build.library()
    ptxas = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    _phase("build", t0, source=str(_build.SOURCE.relative_to(HERE)),
           ptxas=json.dumps(ptxas))
    results = {name: {"name": name, "route": "cuda",
                      "source": "pi_sph_fluid_tpu_torch/csrc/window_kernels.cu",
                      "replaces": k[1]} for name, k in KERNELS.items()}

    t0 = time.perf_counter()
    eng, fluid = pool_engine(N_POOL, DEV)
    compare_kernels(eng, fluid, results)
    _phase("kernels_vs_plain", t0, n_fluid=fluid.n, n_layout=eng.n_layout, L=eng.spec.L)

    t0 = time.perf_counter()
    pool = run_pool(eng, fluid)
    for name in KERNELS:
        results[name]["launches"] = pool["launches"][name]
    _phase("pool_100k", t0, n_fluid=fluid.n,
           **{k: v for k, v in pool.items() if k != "launches"})

    t0 = time.perf_counter()
    worst = run_golden()
    _phase("golden_3k", t0, steps=GOLDEN_STEPS, worst=json.dumps(worst))

    t0 = time.perf_counter()
    big, big_fluid = pool_engine(N_BIG, DEV)
    sim = big.prime(big_fluid, G)
    multi = big.make_multi_step(resort_every=64)
    _sync()
    t1 = time.perf_counter()
    sim, st = multi(sim, _gravity(64))
    _sync()
    wall = time.perf_counter() - t1
    _check_state(sim, st, "1M pool")
    _phase("pool_1m", t0, n_fluid=big_fluid.n, ms_per_step=wall / 64 * 1e3,
           ps_per_s=big_fluid.n * 64 / wall)
    return results


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    _phase("environment", t0, torch=torch.__version__, cuda=torch.version.cuda,
           nvcc=json.dumps(nvcc), gpu=json.dumps(smi))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = run()
    print(json.dumps({"kernels": list(results.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
