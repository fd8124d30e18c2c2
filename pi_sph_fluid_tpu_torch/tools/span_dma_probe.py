"""Does a query block pay for reading its candidates as several disjoint
spans instead of one staged window?  (Port of `tools/span_dma_probe.py`,
the v5e probe of the 3-span megakernel fetch.)

A density-like kernel (csrc/probe_kernels.cu, ``span_density_kernel``, on
the thread mapping of the shipped window kernels: a group of threads a
query, the columns staged chunk by chunk, so any lane count launches) runs
per query block over ``spans`` windows of ``span_cap`` source columns, at
equal lanes and bytes in every variant:

  A: 1 span of 512 columns per block (the shape the window kernels ship);
  B: 4 spans of 128 (the row triple's three spans plus the boundary);
  C: 2 spans of 256 (a middle point).

B/A is the measured price of reading the triple's row spans straight from
the sorted arrays instead of one gathered window.

* ``span_density(q, src, w_s, spans, span_cap, tq=256, qb=16)``: the
  (n_layout, 1) sums; the kernel on CUDA tensors, the plain version on CPU
  ones;
* ``span_density_plain``: the same in plain PyTorch;
* ``run_variant`` / ``main()``: seeded inputs (a ``torch.Generator``), the
  kernel checked nonzero and timed by CUDA events (and the host's
  microseconds a launch), at the JAX default (the
  100k pool's shape: n_layout 101,632, L 234,368) and the 1M pool's
  (n_layout 1,009,152, L 2,115,968).

    python -m pi_sph_fluid_tpu_torch.tools.span_dma_probe [--n-layout N --L L]
"""

from __future__ import annotations

import argparse

import torch

from ..ops.window.window_kernels import _launch
from ..utils.profiling import bound, covered, event_ms, host_us
from ..utils.tracer import tracer

__all__ = ["span_density", "span_density_plain", "span_cost", "make_inputs",
           "run_variant", "main", "VARIANTS"]

LANE = 128
VARIANTS = {"A": (1, 512), "B": (4, 128), "C": (2, 256)}   # (spans, span_cap)
SHAPES = ((101_632, 234_368), (1_009_152, 2_115_968))       # (n_layout, L)
FLOPS_PER_LANE = 14     # sub x2, mul x2, add, sqrt, sub, max, mul x4, add, acc
REPS = 20
# pair lanes materialised at once by the plain version (x ~8 temporaries)
_PLAIN_LANES = 1 << 22


def _geometry(q, w_s, tq, qb):
    n_layout = q.shape[0]
    if n_layout % tq or tq % qb:
        raise ValueError(f"n_layout={n_layout} must be a multiple of tq={tq}, "
                         f"and tq of qb={qb}")
    return n_layout // tq, tq // qb


def _columns(w_s, n_tiles, span_cap, W):
    """(n_tiles, nqb, spans * span_cap) source columns of each block: tile
    t reads w_s[t], starts clamped into [0, W - span_cap]."""
    ws = w_s[:n_tiles].long().clamp(0, W - span_cap)
    idx = ws[..., None] + torch.arange(span_cap, device=w_s.device)
    return idx.reshape(ws.shape[0], ws.shape[1], -1)


def span_density_plain(q, src, w_s, spans: int, span_cap: int,
                       tq: int = 256, qb: int = 16) -> torch.Tensor:
    """Plain PyTorch version, the kernel's per-lane operation order, in
    chunks of tiles."""
    n_tiles, nqb = _geometry(q, w_s, tq, qb)
    W = src.shape[1]
    cols = _columns(w_s, n_tiles, span_cap, W)
    out = torch.empty((q.shape[0], 1), dtype=torch.float32, device=q.device)
    step = max(1, _PLAIN_LANES // (tq * spans * span_cap))
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        c = cols[t0:t1]                                    # (nt, nqb, S)
        cx, cy, cm = (src[k][c][:, :, None, :] for k in range(3))
        qq = q[t0 * tq:t1 * tq].reshape(t1 - t0, nqb, qb, 8)
        dx = qq[..., 0:1] - cx
        dy = qq[..., 1:2] - cy
        r = torch.sqrt(dx * dx + dy * dy)
        t = torch.clamp_min(1.0 - r, 0.0)
        tsq = t * t
        term = (cm * (tsq * tsq)) * (1.0 + r)
        out[t0 * tq:t1 * tq, 0] = term.sum(-1).reshape(-1)
    return out


def _check(q, src, w_s, spans, span_cap, tq, qb):
    dev = q.device
    for name, t, dtype in (("q", q, torch.float32), ("src", src, torch.float32),
                           ("w_s", w_s, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"contiguous {dtype} on {dev}")
    n_tiles, nqb = _geometry(q, w_s, tq, qb)
    if q.dim() != 2 or q.shape[1] != 8:
        raise ValueError(f"q must be (n_layout, 8), got {tuple(q.shape)}")
    if src.dim() != 2 or src.shape[0] < 3 or src.shape[1] < span_cap:
        raise ValueError(f"src must be (>= 3, >= span_cap) rows, got {tuple(src.shape)}")
    if w_s.dim() != 3 or w_s.shape[0] < n_tiles or tuple(w_s.shape[1:]) != (nqb, spans):
        raise ValueError(f"w_s must be (>= {n_tiles}, {nqb}, {spans}), "
                         f"got {tuple(w_s.shape)}")
    if dev.type == "cuda" and not 1 <= qb <= 32:
        raise ValueError(f"qb={qb} must be 1..32 for the kernel")
    return n_tiles, nqb


def span_density(q, src, w_s, spans: int, span_cap: int, tq: int = 256,
                 qb: int = 16) -> torch.Tensor:
    """(n_layout, 1) float32: per query, the density-like sum over its
    block's ``spans`` windows of ``span_cap`` columns of src rows 0-2 (x, y,
    m), window starts ``w_s[t, b, :]`` for block b of tile t.  The kernel on
    CUDA tensors, the plain version on CPU ones."""
    n_tiles, nqb = _check(q, src, w_s, spans, span_cap, tq, qb)
    dev = q.device
    if dev.type == "cpu":
        return span_density_plain(q, src, w_s, spans, span_cap, tq, qb)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    fn, stream = _launch("span_density", dev, "probe_kernels")
    out = torch.empty((q.shape[0], 1), dtype=torch.float32, device=dev)
    err = fn(w_s.data_ptr(), q.data_ptr(), src.data_ptr(), out.data_ptr(),
             n_tiles * nqb, qb, spans, span_cap, src.shape[1], stream)
    if err:
        raise RuntimeError(f"span_density kernel launch failed: CUDA error {err}")
    tracer.count("probe.span_density.launches")
    return out


def span_cost(q, src, w_s, spans: int, span_cap: int, tq: int = 256,
              qb: int = 16) -> dict:
    """Bytes (each distinct source column's x, y, m read once, each start
    once, each query's x, y and its output once), float32 operations (14 a
    pair lane), and the card's bound for them."""
    n_tiles, nqb = _geometry(q, w_s, tq, qb)
    W = src.shape[1]
    ws = w_s[:n_tiles].long().clamp(0, W - span_cap)
    cols = covered(ws, torch.full_like(ws, span_cap), W)
    n = q.shape[0]
    nbytes = cols * 12 + ws.numel() * 4 + n * (8 + 4)
    return dict(source_columns=cols,
                **bound(nbytes, n * spans * span_cap * FLOPS_PER_LANE))


def make_inputs(n_layout: int, L: int, spans: int, span_cap: int, device,
                tq: int = 256, qb: int = 16, seed: int = 0):
    """(q (n_layout, 8), src (8, 2L), w_s (n_tiles, nqb, spans)) from a
    seeded torch.Generator: normal q and src, and random 128-aligned span
    starts in [0, 2L - span_cap), as `span_dma_probe.py:97-102` draws them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_tiles, nqb = n_layout // tq, tq // qb
    src = torch.randn((8, 2 * L), generator=gen, device=device)
    q = torch.randn((n_layout, 8), generator=gen, device=device)
    w_s = torch.randint(0, (2 * L - span_cap) // LANE, (n_tiles, nqb, spans),
                        generator=gen, device=device, dtype=torch.int32) * LANE
    return q, src, w_s


def run_variant(n_layout: int, L: int, spans: int, span_cap: int, tq: int = 256,
                qb: int = 16, reps: int = REPS) -> tuple[float, float]:
    """(ms per launch of the kernel on seeded inputs by CUDA events, host
    microseconds per launch), after checking that it produced something
    other than zeros."""
    q, src, w_s = make_inputs(n_layout, L, spans, span_cap, "cuda", tq, qb)
    out = span_density(q, src, w_s, spans, span_cap, tq, qb)
    if not bool(torch.any(out != 0.0)):
        raise AssertionError("kernel produced all zeros")
    launch = lambda: span_density(q, src, w_s, spans, span_cap, tq, qb)  # noqa: E731
    return event_ms(launch, reps), host_us(launch, reps)


def main(argv=None) -> dict:
    """A, B and C ms with B/A and C/A at each shape; returns {shape: row}.
    Needs a CUDA device."""
    ap = argparse.ArgumentParser(prog="span_dma_probe")
    ap.add_argument("--n-layout", type=int, default=None)
    ap.add_argument("--L", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_dma_probe: needs a CUDA device")
    if (args.n_layout is None) != (args.L is None):
        raise SystemExit("give both --n-layout and --L, or neither")
    shapes = SHAPES if args.L is None else ((args.n_layout, args.L),)
    out = {}
    for n_layout, L in shapes:
        nl = n_layout // 256 * 256
        runs = {v: run_variant(nl, L, *sc) for v, sc in VARIANTS.items()}
        row = {v: ms for v, (ms, _) in runs.items()}
        row["B_over_A"], row["C_over_A"] = row["B"] / row["A"], row["C"] / row["A"]
        row["host_us"] = min(us for _, us in runs.values())
        print(f"n_layout={nl} L={L}: A 1x512: {row['A']:7.4f} ms   "
              f"B 4x128: {row['B']:7.4f} ms   C 2x256: {row['C']:7.4f} ms   "
              f"(host {row['host_us']:.2f} us a launch)", flush=True)
        print(f"  equal lanes+bytes; B/A = {row['B_over_A']:.3f}x, "
              f"C/A = {row['C_over_A']:.3f}x", flush=True)
        out[f"n{nl}_L{L}"] = row
    return out


if __name__ == "__main__":
    main()
