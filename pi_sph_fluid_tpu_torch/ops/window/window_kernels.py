"""Density and forces window passes: CUDA kernels and their plain versions
(port of `pi_sph_fluid_tpu/ops/pallas/window_kernels.py:192-497`).

Each pass works per block of ``qb`` consecutive layout queries over the
block's one contiguous candidate window (ops/window/triple.py):

* ``density_window``: Wendland density with the self term, then the Tait
  EOS epilogue; returns geo8 = [x, y, u, v, m, p/rho^2, rho/2, 0.5] (the
  fluid force-candidate rows) and rp = [rho, p]  (`pi_sph_fluid.c:263-301`);
* ``forces_window``: symmetric pressure + Macklin artificial pressure +
  Monaghan viscosity + gravity, with the trailing half-kick fused in;
  returns pk_next (the finished packed state) and acc = [au, av]
  (`pi_sph_fluid.c:303-373`, `:637-640`).

Candidates are row-major, (L, 4) [x, y, m~, 0] for density and (L, 8)
[x, y, u, v, m~, cp, re, a] for forces (the TPU kernels' (k, L) planes
transposed), so a candidate is one or two 16-byte loads.

Dispatch: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the hand-written kernel (csrc/window_kernels.cu) or raises.  Each
wrapper's ``launches`` counts kernel launches and nothing else.

The plain versions compute the same lanes as the kernels, [w_start,
w_start + min(w_len, cap)), over an explicit (blocks, qb, cap) window, in
chunks of blocks so that they also run at 1M particles on the card.  Lanes
past w_len, which the TPU kernels computed, contribute exactly 0 there (or
below 1e-28 where rounding leaves the support clamp one ulp above 0).
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import SPHConfig
from ...core.pair_terms import artificial_pressure_ref_w
from .triple import TripleSpec

__all__ = ["density_window", "forces_window", "density_window_plain",
           "forces_window_plain", "density_consts", "forces_consts"]

_F32 = np.float32
# lanes materialised at once by the plain versions (x ~10 temporaries)
_PLAIN_LANES = 1 << 22


def density_consts(cfg: SPHConfig) -> dict:
    """Float32 constants of the density pass, rounded as
    `window_kernels.py:211-215` rounds them."""
    h = _F32(cfg.h)
    return dict(norm=float(_F32(cfg.kernel_norm)),
                half_inv_h=float(_F32(0.5) / h),
                two_inv_h=float(_F32(2.0) / h),
                inv_rho0=float(_F32(1.0 / cfg.rho_0)),
                tait_b=float(_F32(cfg.tait_b)))


def forces_consts(cfg: SPHConfig) -> dict:
    """Float32 constants of the forces pass (`window_kernels.py:354-364`)."""
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


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                         f"{dtype} {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_windows(spec: TripleSpec, q_packed, geo, k, w_start, w_len):
    dev = q_packed.device
    _check("q_packed", q_packed, (spec.n_layout, 8), torch.float32, dev)
    if geo.dim() != 2 or geo.shape[1] != k:
        raise ValueError(f"candidates must be (L, {k}), got {tuple(geo.shape)}")
    _check("candidates", geo, geo.shape, torch.float32, dev)
    _check("w_start", w_start, (spec.n_tiles, spec.nqb), torch.int32, dev)
    _check("w_len", w_len, (spec.n_tiles, spec.nqb), torch.int32, dev)
    if dev.type == "cuda" and not 1 <= spec.qb <= 32:
        raise ValueError(f"qb={spec.qb}: one warp per query needs 1 <= qb <= 32")


def _windows(w_start, w_len, b0, b1, cap, L):
    """(nb, <= cap) candidate rows and lane validity for blocks [b0, b1): the
    kernels' clamped window [start, start + min(len, cap)) within [0, L)."""
    ws = w_start.reshape(-1)[b0:b1].clamp(0, L)
    wl = torch.clamp_max(torch.minimum(w_len.reshape(-1)[b0:b1].clamp_min(0),
                                       L - ws), cap)
    # lanes past the chunk's longest window are all invalid: skip them
    width = max(int(wl.max()), 1)
    lane = torch.arange(width, dtype=torch.int32, device=ws.device)
    valid = lane[None, :] < wl[:, None]
    idx = torch.clamp_max(ws[:, None] + lane[None, :], L - 1).long()
    return idx, valid


def _chunk(spec: TripleSpec) -> int:
    return max(1, _PLAIN_LANES // (spec.qb * spec.cap))


def _zero(t):
    return torch.zeros((), dtype=t.dtype, device=t.device)


# ---------------------------------------------------------------------------
# density
# ---------------------------------------------------------------------------


def density_window_plain(q_packed, geo_d, w_start, w_len, cfg: SPHConfig,
                         spec: TripleSpec):
    """Plain PyTorch version of the density kernel, same lanes, same
    per-lane and epilogue operation order."""
    c = density_consts(cfg)
    n_blocks, qb, L = spec.n_layout // spec.qb, spec.qb, geo_d.shape[0]
    rho = torch.empty(spec.n_layout, dtype=torch.float32, device=q_packed.device)
    step = _chunk(spec)
    for b0 in range(0, n_blocks, step):
        b1 = min(b0 + step, n_blocks)
        idx, valid = _windows(w_start, w_len, b0, b1, spec.cap, L)
        cand = geo_d[idx]                                   # (nb, cap, 4)
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


def density_window(q_packed, geo_d, w_start, w_len, cfg: SPHConfig,
                   spec: TripleSpec):
    """(geo8 (n_layout, 8), rp (n_layout, 2)) from the (L, 4) density
    candidates; the kernel on CUDA tensors, the plain version on CPU ones."""
    _check_windows(spec, q_packed, geo_d, 4, w_start, w_len)
    if q_packed.device.type == "cpu":
        return density_window_plain(q_packed, geo_d, w_start, w_len, cfg, spec)
    if q_packed.device.type != "cuda":
        raise ValueError(f"no window kernel for device {q_packed.device}")
    from ._build import library

    lib, _ = library()
    geo8 = torch.empty_like(q_packed)
    rp = torch.empty((spec.n_layout, 2), dtype=torch.float32,
                     device=q_packed.device)
    c = density_consts(cfg)
    err = lib.density_window(
        q_packed.data_ptr(), geo_d.data_ptr(), w_start.data_ptr(),
        w_len.data_ptr(), geo8.data_ptr(), rp.data_ptr(),
        spec.n_layout // spec.qb, spec.qb, spec.cap, geo_d.shape[0],
        c["norm"], c["half_inv_h"], c["two_inv_h"], c["inv_rho0"],
        c["tait_b"], torch.cuda.current_stream(q_packed.device).cuda_stream)
    if err:
        raise RuntimeError(f"density_window kernel launch failed: CUDA error {err}")
    density_window.launches += 1
    return geo8, rp


density_window.launches = 0


# ---------------------------------------------------------------------------
# forces
# ---------------------------------------------------------------------------


def forces_window_plain(q_packed, geo8, rp, geo_f, w_start, w_len, g,
                        cfg: SPHConfig, spec: TripleSpec,
                        half_dt: float = 0.0, damp: float = 1.0):
    """Plain PyTorch version of the forces kernel, same lanes, same
    per-lane and epilogue operation order."""
    c = forces_consts(cfg)
    n_blocks, qb, L = spec.n_layout // spec.qb, spec.qb, geo_f.shape[0]
    sums = torch.empty((spec.n_layout, 2), dtype=torch.float32,
                       device=q_packed.device)
    q_rho_all = 2.0 * geo8[:, 6]
    q_press_all = geo8[:, 5]
    step = _chunk(spec)
    for b0 in range(0, n_blocks, step):
        b1 = min(b0 + step, n_blocks)
        idx, valid = _windows(w_start, w_len, b0, b1, spec.cap, L)
        cand = geo_f[idx][:, None]                          # (nb, 1, cap, 8)
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


def forces_window(q_packed, geo8, rp, geo_f, w_start, w_len, g,
                  cfg: SPHConfig, spec: TripleSpec,
                  half_dt: float = 0.0, damp: float = 1.0):
    """(pk_next (n_layout, 8), acc (n_layout, 2)) from the density outputs
    and the (L, 8) force candidates.  ``g`` is a host pair of floats;
    ``half_dt`` and ``damp`` are taken in float32.  The kernel on CUDA
    tensors, the plain version on CPU ones."""
    _check_windows(spec, q_packed, geo_f, 8, w_start, w_len)
    dev = q_packed.device
    _check("geo8", geo8, (spec.n_layout, 8), torch.float32, dev)
    _check("rp", rp, (spec.n_layout, 2), torch.float32, dev)
    if dev.type == "cpu":
        return forces_window_plain(q_packed, geo8, rp, geo_f, w_start, w_len,
                                   g, cfg, spec, half_dt, damp)
    if dev.type != "cuda":
        raise ValueError(f"no window kernel for device {dev}")
    from ._build import library

    lib, _ = library()
    pk_next = torch.empty_like(q_packed)
    acc = torch.empty((spec.n_layout, 2), dtype=torch.float32, device=dev)
    c = forces_consts(cfg)
    gx, gy = (float(v) for v in g)
    err = lib.forces_window(
        q_packed.data_ptr(), geo8.data_ptr(), rp.data_ptr(), geo_f.data_ptr(),
        w_start.data_ptr(), w_len.data_ptr(), pk_next.data_ptr(),
        acc.data_ptr(), spec.n_layout // spec.qb, spec.qb, spec.cap,
        geo_f.shape[0], gx, gy, float(_F32(half_dt)), float(_F32(damp)),
        c["half_inv_h"], c["two_inv_h"], c["eps_h2"], c["nach"], c["k_ap4"],
        c["gfac"], torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"forces_window kernel launch failed: CUDA error {err}")
    forces_window.launches += 1
    return pk_next, acc


forces_window.launches = 0
