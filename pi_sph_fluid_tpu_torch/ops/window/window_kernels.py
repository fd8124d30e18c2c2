"""Density and forces window passes: CUDA kernels and their plain versions
(port of `pi_sph_fluid_tpu/ops/pallas/window_kernels.py:192-497`).

Each pass works per block of ``qb`` consecutive layout queries over the
lanes of the block's candidate window, read as the block's spans
(ops/window/triple.py::block_spans) straight from the arrays the
candidates live in; no candidate array is gathered:

* ``density_window``: Wendland density with the self term, then the Tait
  EOS epilogue; fluid candidates are the rows of the packed state itself
  (x, y and m of [x, y, u, v | m, rho, p, id]), boundary candidates the
  static rows [x, y, psi, 0]; returns geo8 = [x, y, u, v, m, p/rho^2,
  rho/2, 0.5] (the fluid force-candidate rows) and rp = [rho, p]
  (`pi_sph_fluid.c:263-301`);
* ``forces_window``: symmetric pressure + Macklin artificial pressure +
  Monaghan viscosity + gravity, with the trailing half-kick fused in;
  fluid candidates are the rows of geo8, boundary candidates the static
  rows [x, y, 0, 0, psi, 0, 0, 1]; returns pk_next (the finished packed
  state) and acc = [au, av]  (`pi_sph_fluid.c:303-373`, `:637-640`).

Both compute the first ``min(sum of span lengths, cap)`` lanes in span
order.  Under a sticky layout the spans are the relayout's and the rows
they name are read from the current state.  The forces kernel does a
lane's full arithmetic only where the candidate is within the support
radius (widened by 1e-4; a non-finite distance counts as within);
elsewhere the lane's term is exactly 0, which is what the plain version
adds there for finite rows.  A non-finite cp, re, u or v of a row out of a
query's reach therefore does not poison that query in the kernel, where
the plain version and the TPU kernel compute NaN * 0; a non-finite
position poisons in both.

Dispatch: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the hand-written kernel (csrc/window_kernels.cu) or raises.  Each
wrapper counts its kernel launches, and nothing else, in utils/tracer.py's
counters (``kernel.density.launches``, ``kernel.forces.launches``).  The
float32 constants of a pass are computed once per config, and a launch
spends its host time on the checks, two allocations and the call.

The renderer's field kernel (render/metaballs_window.py) shares the launch
path, the checks and the lane table of this module; it reads the fluid
half of its blocks' spans and resolves them itself from a start grid
(``_grid_spans``).

The plain versions compute the same lanes as the kernels over an explicit
(blocks, qb, lanes) array, in chunks of blocks so that they also run at 1M
particles on the card.  Lanes past the window, which the TPU kernels
computed, contribute exactly 0 there (or below 1e-28 where rounding leaves
the support clamp one ulp above 0).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...config import SPHConfig
from ...core.pair_terms import artificial_pressure_ref_w
from ...utils.tracer import tracer
from .triple import TripleSpec

__all__ = ["density_window", "forces_window", "density_window_plain",
           "forces_window_plain", "density_consts", "forces_consts"]

_F32 = np.float32
# lanes materialised at once by the plain versions (x ~10 temporaries)
_PLAIN_LANES = 1 << 22
# most spans a block may have (the kernels keep the table in shared memory)
MAX_SPANS = 16


@functools.lru_cache(maxsize=None)
def density_consts(cfg: SPHConfig) -> dict:
    """Float32 constants of the density pass, rounded as
    `window_kernels.py:211-215` rounds them.  Computed once per config
    (SPHConfig is frozen); callers must not modify the dict."""
    h = _F32(cfg.h)
    return dict(norm=float(_F32(cfg.kernel_norm)),
                half_inv_h=float(_F32(0.5) / h),
                two_inv_h=float(_F32(2.0) / h),
                inv_rho0=float(_F32(1.0 / cfg.rho_0)),
                tait_b=float(_F32(cfg.tait_b)))


@functools.lru_cache(maxsize=None)
def forces_consts(cfg: SPHConfig) -> dict:
    """Float32 constants of the forces pass (`window_kernels.py:354-364`),
    computed once per config like ``density_consts``."""
    h = _F32(cfg.h)
    wref = _F32(float(artificial_pressure_ref_w(cfg)) / float(cfg.kernel_norm))
    inv = _F32(1.0) / wref
    inv2 = inv * inv
    return dict(half_inv_h=float(_F32(0.5) / h),
                two_inv_h=float(_F32(2.0) / h),
                eps_h2=float(_F32(cfg.eps_visc) * h * h),
                nach=float(_F32(-cfg.alpha_visc) * _F32(cfg.c) * h),
                k_ap4=float(_F32(cfg.k_artificial_pressure) * (inv2 * inv2)),
                gfac=float(_F32(5.0) * _F32(cfg.kernel_norm) / (h * h)))


@functools.lru_cache(maxsize=None)
def _const_args(consts, cfg: SPHConfig) -> tuple:
    """The constants of ``consts(cfg)`` in the kernel's argument order."""
    return tuple(consts(cfg).values())


def _check(name, t, shape, dtype, device):
    """Device, type, shape and contiguity of one kernel argument."""
    if (t.shape != shape or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}; "
                         f"expected contiguous {dtype} {tuple(shape)} on {device}")


def _check_grid_spans(spec: TripleSpec, q_packed, rows, grid, span_idx):
    """The arguments of a kernel that resolves its blocks' fluid spans
    itself (the renderer's field kernel): queries, the (n, 8) source rows,
    the start grid and the blocks' index pairs into it.  Returns the
    device."""
    dev = q_packed.device
    _check("q_packed", q_packed, (spec.n_layout, 8), torch.float32, dev)
    if rows.dim() != 2:
        raise ValueError(f"source rows must be (n, 8), got {tuple(rows.shape)}")
    _check("source rows", rows, (rows.shape[0], 8), torch.float32, dev)
    if grid.dim() != 1 or grid.shape[0] < 1:
        raise ValueError(f"start grid must be (n >= 1,), got {tuple(grid.shape)}")
    _check("start grid", grid, grid.shape, torch.int32, dev)
    _check("span_idx", span_idx, (spec.n_layout // spec.qb, spec.seg_q + 2, 2),
           torch.int32, dev)
    if not (1 <= spec.qb <= 32 and spec.n_spans <= MAX_SPANS):
        raise ValueError(f"qb={spec.qb} must be 1..32 and n_spans="
                         f"{spec.n_spans} at most {MAX_SPANS}")
    return dev


def _check_spans(spec: TripleSpec, q_packed, b_geo, k, spans):
    """The arguments both span kernels share.  Returns the device."""
    dev = q_packed.device
    _check("q_packed", q_packed, (spec.n_layout, 8), torch.float32, dev)
    if b_geo.dim() != 2:
        raise ValueError(f"boundary rows must be (nb, {k}), got {tuple(b_geo.shape)}")
    _check("boundary rows", b_geo, (b_geo.shape[0], k), torch.float32, dev)
    _check("spans", spans, (spec.n_layout // spec.qb, spec.n_spans, 2),
           torch.int32, dev)
    if not (1 <= spec.qb <= 32 and spec.n_spans <= MAX_SPANS):
        raise ValueError(f"qb={spec.qb} must be 1..32 and n_spans="
                         f"{spec.n_spans} at most {MAX_SPANS}")
    return dev


def _lanes(start, length, cap):
    """(nb, <= cap) source rows and lane validity from (nb, ns) clamped span
    starts and lengths: a block's spans laid end to end, its first min(sum
    of lengths, cap) lanes."""
    nb, ns = start.shape
    pref = torch.cumsum(length, 1)                          # inclusive
    total = pref[:, -1].clamp_max(cap)
    # lanes past the chunk's longest window are all invalid: skip them
    width = max(int(total.max()), 1)
    lane = torch.arange(width, device=start.device)[None, :].expand(nb, width)
    k = torch.searchsorted(pref, lane.contiguous(), right=True).clamp_max(ns - 1)
    row0 = start - (pref - length)
    valid = lane < total[:, None]
    idx = torch.where(valid, row0.gather(1, k) + lane, 0)
    return idx, valid


def _span_lanes(spans, b0, b1, cap, n_fluid, n_bnd):
    """(nb, <= cap) candidate rows and lane validity for blocks [b0, b1) in
    span order, as rows of ``cat([fluid rows, boundary rows])``.  The first
    half of a block's spans names fluid rows, the second boundary rows;
    each is clamped into its array as the kernels clamp it, and a block
    computes its first min(sum of lengths, cap) lanes."""
    sp = spans[b0:b1].long()
    ns = sp.shape[1]
    fluid = torch.arange(ns, device=sp.device) < ns // 2
    n_src = torch.where(fluid, n_fluid, n_bnd)
    start = torch.minimum(sp[..., 0].clamp_min(0), n_src)
    length = torch.minimum(sp[..., 1].clamp_min(0), n_src - start)
    return _lanes(start + torch.where(fluid, 0, n_fluid), length, cap)


def _grid_spans(span_idx, grid, n_src):
    """(start, length), each (blocks, ns) int64, of the spans a kernel
    resolves itself (the field kernel): span k of a block is source rows
    [grid[i_lo], grid[i_hi]) for its index pair ``span_idx[b, k]``, the
    indices clamped into the grid and the span into [0, n_src) as the
    kernel clamps them."""
    ix = span_idx.long().clamp(0, grid.shape[0] - 1)
    g = grid.long()
    s = g[ix[..., 0]]
    start = s.clamp(0, n_src)
    return start, torch.minimum((g[ix[..., 1]] - s).clamp_min(0), n_src - start)


def _chunk(spec: TripleSpec) -> int:
    return max(1, _PLAIN_LANES // (spec.qb * spec.cap))


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


_ENTRIES: dict = {}     # entry point name -> bound ctypes function


def _launch(name: str, dev, lib: str = "window_kernels"):
    """Entry point ``name`` of the kernel library ``lib`` (built and looked
    up at its first launch) and the raw handle of the current stream of the
    CUDA device ``dev``: one dictionary lookup and one call per launch."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from ._build import library

        fn = _ENTRIES[name] = getattr(library(lib)[0], name)
    return fn, torch._C._cuda_getCurrentRawStream(dev.index)


# ---------------------------------------------------------------------------
# density
# ---------------------------------------------------------------------------


def density_window_plain(q_packed, b_geo_d, spans, cfg: SPHConfig,
                         spec: TripleSpec):
    """Plain PyTorch version of the density kernel, same lanes, same
    per-lane and epilogue operation order."""
    c = density_consts(cfg)
    n_blocks, qb = spec.n_layout // spec.qb, spec.qb
    src = torch.cat([torch.cat([q_packed[:, 0:2], q_packed[:, 4:5]], 1),
                     b_geo_d[:, 0:3]])                      # x, y, m~
    rho = torch.empty(spec.n_layout, dtype=torch.float32, device=q_packed.device)
    step = _chunk(spec)
    for b0 in range(0, n_blocks, step):
        b1 = min(b0 + step, n_blocks)
        idx, valid = _span_lanes(spans, b0, b1, spec.cap, spec.n_layout,
                                 b_geo_d.shape[0])
        cand = src[idx]                                     # (nb, lanes, 3)
        q = q_packed[b0 * qb:b1 * qb].reshape(b1 - b0, qb, 8)
        dx = q[:, :, 0:1] - cand[:, None, :, 0]
        dy = q[:, :, 1:2] - cand[:, None, :, 1]
        r = torch.sqrt(dx * dx + dy * dy)
        t1 = torch.clamp_min(1.0 - c["half_inv_h"] * r, 0.0)
        t1sq = t1 * t1
        term = (cand[:, None, :, 2] * (t1sq * t1sq)) * (1.0 + c["two_inv_h"] * r)
        term = torch.where(valid[:, None, :], term, _zero(term))
        rho[b0 * qb:b1 * qb] = c["norm"] * term.sum(-1).reshape(-1)
    ratio = rho * c["inv_rho0"]
    rr2 = ratio * ratio
    rr4 = rr2 * rr2
    p = torch.clamp_min(c["tait_b"] * (rr4 * rr2 * ratio - 1.0), 0.0)
    cp = torch.where(rho > 0.0, p / (rho * rho), _zero(p))
    geo8 = q_packed.clone()
    geo8[:, 5] = cp
    geo8[:, 6] = 0.5 * rho
    geo8[:, 7] = 0.5
    return geo8, torch.stack([rho, p], 1)


def density_window(q_packed, b_geo_d, spans, cfg: SPHConfig, spec: TripleSpec):
    """(geo8 (n_layout, 8), rp (n_layout, 2)) from the packed state (queries
    and fluid candidates), the (nb, 4) boundary rows [x, y, psi, 0] and the
    per-block span table; the kernel on CUDA tensors, the plain version on
    CPU ones."""
    dev = _check_spans(spec, q_packed, b_geo_d, 4, spans)
    if dev.type == "cpu":
        return density_window_plain(q_packed, b_geo_d, spans, cfg, spec)
    if dev.type != "cuda":
        raise ValueError(f"no window kernel for device {dev}")
    fn, stream = _launch("density_window", dev)
    geo8 = torch.empty_like(q_packed)
    rp = torch.empty((spec.n_layout, 2), dtype=torch.float32, device=dev)
    err = fn(q_packed.data_ptr(), b_geo_d.data_ptr(), spans.data_ptr(),
             geo8.data_ptr(), rp.data_ptr(), spec.n_layout // spec.qb, spec.qb,
             spec.cap, spec.n_spans, spec.n_layout, b_geo_d.shape[0],
             *_const_args(density_consts, cfg), stream)
    if err:
        raise RuntimeError(f"density_window kernel launch failed: CUDA error {err}")
    tracer.count("kernel.density.launches")
    return geo8, rp


# ---------------------------------------------------------------------------
# forces
# ---------------------------------------------------------------------------


def forces_window_plain(q_packed, geo8, rp, b_geo_f, spans, g,
                        cfg: SPHConfig, spec: TripleSpec,
                        half_dt: float = 0.0, damp: float = 1.0):
    """Plain PyTorch version of the forces kernel, same lanes, same
    per-lane and epilogue operation order."""
    c = forces_consts(cfg)
    n_blocks, qb = spec.n_layout // spec.qb, spec.qb
    src = torch.cat([geo8, b_geo_f])
    sums = torch.empty((spec.n_layout, 2), dtype=torch.float32,
                       device=q_packed.device)
    q_rho_all = 2.0 * geo8[:, 6]
    q_press_all = geo8[:, 5]
    step = _chunk(spec)
    for b0 in range(0, n_blocks, step):
        b1 = min(b0 + step, n_blocks)
        idx, valid = _span_lanes(spans, b0, b1, spec.cap, spec.n_layout,
                                 b_geo_f.shape[0])
        cand = src[idx][:, None]                            # (nb, 1, lanes, 8)
        q = q_packed[b0 * qb:b1 * qb].reshape(b1 - b0, qb, 1, 8)
        q_rho = q_rho_all[b0 * qb:b1 * qb].reshape(b1 - b0, qb, 1)
        q_press = q_press_all[b0 * qb:b1 * qb].reshape(b1 - b0, qb, 1)
        dx = q[..., 0] - cand[..., 0]
        dy = q[..., 1] - cand[..., 1]
        du = q[..., 2] - cand[..., 2]
        dv = q[..., 3] - cand[..., 3]
        r2 = dx * dx + dy * dy
        r = torch.sqrt(r2)
        t1 = torch.clamp_min(1.0 - c["half_inv_h"] * r, 0.0)
        t1sq = t1 * t1
        t13 = t1sq * t1
        w_un = (t1sq * t1sq) * (1.0 + c["two_inv_h"] * r)
        press = q_press + cand[..., 5]
        w2 = w_un * w_un
        artif = c["k_ap4"] * (w2 * w2)
        xy_uv = dx * du + dy * dv
        denom = cand[..., 7] * q_rho + cand[..., 6]
        den = (r2 + c["eps_h2"]) * denom
        visc = (c["nach"] * torch.clamp_max(xy_uv, 0.0)) / den
        coef = cand[..., 4] * (press + artif + visc) * t13
        keep = valid[:, None, :]
        ax = torch.where(keep, coef * dx, _zero(coef)).sum(-1)
        ay = torch.where(keep, coef * dy, _zero(coef)).sum(-1)
        sums[b0 * qb:b1 * qb] = torch.stack([ax, ay], -1).reshape(-1, 2)
    real = q_packed[:, 4] > 0.0
    gx, gy = (float(v) for v in g)
    au = torch.where(real, gx + c["gfac"] * sums[:, 0], _zero(sums))
    av = torch.where(real, gy + c["gfac"] * sums[:, 1], _zero(sums))
    half_f, damp_f = float(_F32(half_dt)), float(_F32(damp))
    pk_next = q_packed.clone()
    pk_next[:, 2] = (q_packed[:, 2] + half_f * au) * damp_f
    pk_next[:, 3] = (q_packed[:, 3] + half_f * av) * damp_f
    pk_next[:, 5:7] = rp
    return pk_next, torch.stack([au, av], 1)


def forces_window(q_packed, geo8, rp, b_geo_f, spans, g,
                  cfg: SPHConfig, spec: TripleSpec,
                  half_dt: float = 0.0, damp: float = 1.0):
    """(pk_next (n_layout, 8), acc (n_layout, 2)) from the density outputs
    (geo8 holds the fluid candidates), the (nb, 8) boundary rows [x, y, 0,
    0, psi, 0, 0, 1] and the per-block span table.  ``g`` is a host pair of
    floats; ``half_dt`` and ``damp`` are taken in float32 (the kernel's
    float arguments round them).  The kernel on CUDA tensors, the plain
    version on CPU ones."""
    dev = _check_spans(spec, q_packed, b_geo_f, 8, spans)
    _check("geo8", geo8, (spec.n_layout, 8), torch.float32, dev)
    _check("rp", rp, (spec.n_layout, 2), torch.float32, dev)
    if dev.type == "cpu":
        return forces_window_plain(q_packed, geo8, rp, b_geo_f, spans, g, cfg,
                                   spec, half_dt, damp)
    if dev.type != "cuda":
        raise ValueError(f"no window kernel for device {dev}")
    fn, stream = _launch("forces_window", dev)
    pk_next = torch.empty_like(q_packed)
    acc = torch.empty((spec.n_layout, 2), dtype=torch.float32, device=dev)
    err = fn(q_packed.data_ptr(), geo8.data_ptr(), rp.data_ptr(),
             b_geo_f.data_ptr(), spans.data_ptr(), pk_next.data_ptr(),
             acc.data_ptr(), spec.n_layout // spec.qb, spec.qb, spec.cap,
             spec.n_spans, spec.n_layout, b_geo_f.shape[0], float(g[0]),
             float(g[1]), float(half_dt), float(damp), *_const_args(forces_consts, cfg), stream)
    if err:
        raise RuntimeError(f"forces_window kernel launch failed: CUDA error {err}")
    tracer.count("kernel.forces.launches")
    return pk_next, acc
