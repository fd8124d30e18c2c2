"""Does an unaligned window start cost anything on the card?  (Port of
`tools/unaligned_probe.py`, the v5e probe of lane-unaligned DMA starts.)

The port's kernels fetch every candidate window at its exact start (no
128-lane alignment, no dual 64-shifted planes).  This probe measures what
that choice costs: a per-window copy kernel (csrc/probe_kernels.cu,
``window_copy_kernel``) runs over the same (K, L) float32 source twice,
once from 128-aligned starts with 16-byte vector loads and once from odd
starts with 4-byte loads; both are checked bitwise against the plain slice
and timed by CUDA events and by the profiler's device time, beside the one
PyTorch call that computes the same windows (``src[:, idx]``).

* ``window_copy(starts, src, cap=128, aligned=False)``: (n_tiles, NB, K,
  cap) windows ``src[:, s:s+cap]``; the kernel on CUDA tensors, the plain
  version on CPU ones;
* ``window_copy_plain``: the same in plain PyTorch;
* ``main()``: the JAX probe's shape (L = 2^18, 64 tiles of 16 windows:
  about 7.5 MB moved, launch-bound on an H100) and one past the 50 MB L2 (L =
  2^24, 4096 tiles: 268 MB out).

    python -m pi_sph_fluid_tpu_torch.tools.unaligned_probe
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.window.window_kernels import _launch
from ..utils.profiling import (bound, call_device_ms, covered, event_ms,
                               host_us, kernel_device_ms)
from ..utils.tracer import tracer

__all__ = ["window_copy", "window_copy_plain", "copy_cost", "make_starts", "main"]

LANE = 128
K = 8          # source rows
CAP = 128      # columns copied per window
NB = 16        # windows per tile
SHAPES = ((1 << 18, 64), (1 << 24, 4096))   # (L, n_tiles)
REPS = 20


def _starts(starts: torch.Tensor, L: int, cap: int) -> torch.Tensor:
    """Window starts clamped into [0, L - cap], as XLA's dynamic slice
    clamps them."""
    return starts.clamp(0, L - cap)


def window_copy_plain(starts: torch.Tensor, src: torch.Tensor,
                      cap: int = CAP) -> torch.Tensor:
    """Plain PyTorch version: out[t, b] = src[:, s:s+cap], s = starts[t, b]."""
    L = src.shape[1]
    idx = _starts(starts.long(), L, cap)[..., None] + torch.arange(
        cap, device=src.device)
    return src[:, idx].permute(1, 2, 0, 3).contiguous()


def _check(starts, src, cap):
    if starts.dim() != 2 or starts.dtype != torch.int32:
        raise ValueError(f"starts: {starts.dtype} {tuple(starts.shape)}, "
                         "expected int32 (n_tiles, NB)")
    if src.dim() != 2 or src.dtype != torch.float32:
        raise ValueError(f"src: {src.dtype} {tuple(src.shape)}, expected "
                         "float32 (K, L)")
    if starts.device != src.device:
        raise ValueError(f"starts on {starts.device}, src on {src.device}")
    if not (starts.is_contiguous() and src.is_contiguous()):
        raise ValueError("starts and src must be contiguous")
    if cap % 4 or not 0 < cap <= src.shape[1]:
        raise ValueError(f"cap={cap} must be a positive multiple of 4 up to L")


def window_copy(starts: torch.Tensor, src: torch.Tensor, cap: int = CAP,
                aligned: bool = False) -> torch.Tensor:
    """(n_tiles, NB, K, cap) float32 windows of the (K, L) source at the
    (n_tiles, NB) int32 starts.  ``aligned`` promises starts that are
    multiples of 4 floats (the probe's are multiples of 128) and takes the
    kernel's 16-byte loads; a start that breaks the promise is still copied
    right.  The kernel on CUDA tensors, the plain version on CPU ones."""
    _check(starts, src, cap)
    dev = src.device
    if dev.type == "cpu":
        return window_copy_plain(starts, src, cap)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    fn, stream = _launch("window_copy", dev, "probe_kernels")
    n_tiles, nb = starts.shape
    k, L = src.shape
    out = torch.empty((n_tiles, nb, k, cap), dtype=torch.float32, device=dev)
    err = fn(starts.data_ptr(), src.data_ptr(), out.data_ptr(), n_tiles * nb,
             k, L, cap, int(aligned), stream)
    if err:
        raise RuntimeError(f"window_copy kernel launch failed: CUDA error {err}")
    tracer.count("probe.window_copy.launches")
    return out


def copy_cost(starts: torch.Tensor, src: torch.Tensor, cap: int = CAP) -> dict:
    """Bytes the copy must move (each distinct source column of the K rows
    read once, each start read once, each output written once), no
    arithmetic, and the card's bound for them."""
    k, L = src.shape
    cols = covered(_starts(starts.long(), L, cap),
                   torch.full_like(starts, cap, dtype=torch.int64), L)
    nbytes = cols * k * 4 + starts.numel() * (4 + k * cap * 4)
    return dict(source_columns=cols, **bound(nbytes, 0))


def make_starts(L: int, n_tiles: int, seed: int = 0):
    """(source, aligned starts, odd starts) as numpy arrays, drawn as the
    JAX probe draws them (`tools/unaligned_probe.py:79-86`)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((K, L)).astype(np.float32)
    al = rng.integers(0, (L - 2 * LANE) // LANE, size=(n_tiles, NB)) * LANE
    un = al + rng.integers(1, 127, size=al.shape)
    return src, al.astype(np.int32), un.astype(np.int32)


def main(argv=None) -> dict:
    """Copies and times both forms at each shape (CUDA events, the
    profiler's device ms and the host's microseconds a launch), with the
    library call ``src[:, idx]`` on the same windows beside them; returns
    {shape: {form: ms, ...}} with the aligned/unaligned ratio.  Needs a
    CUDA device."""
    argparse.ArgumentParser(prog="unaligned_probe").parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("unaligned_probe: needs a CUDA device")
    dev = torch.device("cuda")
    out = {}
    for L, n_tiles in SHAPES:
        src_np, al, un = make_starts(L, n_tiles)
        src = torch.from_numpy(src_np).to(dev)
        row = {}
        for tag, st, aligned in (("aligned", al, True), ("unaligned", un, False)):
            starts = torch.from_numpy(st).to(dev)
            got = window_copy(starts, src, aligned=aligned)
            ok = torch.equal(got, window_copy_plain(starts, src))
            if not ok:
                raise AssertionError(f"L={L} {tag}: copied bytes differ from the slice")
            copy = lambda: window_copy(starts, src, aligned=aligned)  # noqa: E731
            row[tag] = event_ms(copy, REPS)
            print(f"L={L} n_tiles={n_tiles} {tag}: ok={ok}  {row[tag]:.4f} ms for "
                  f"{n_tiles}x{NB} window copies", flush=True)
            # the one PyTorch call that computes the same, as a yardstick
            idx = (starts.long()[..., None] + torch.arange(CAP, device=dev)).contiguous()
            row[f"{tag}_device"] = kernel_device_ms(copy, "window_copy_kernel", dev)
            row[f"{tag}_host_us"] = host_us(copy, REPS)
            row[f"{tag}_library"] = event_ms(lambda: src[:, idx], REPS)
            row[f"{tag}_library_device"] = call_device_ms(lambda: src[:, idx], dev)
            print(f"  on the device {row[tag + '_device']:.4f} ms, host "
                  f"{row[tag + '_host_us']:.2f} us a launch; src[:, idx]: "
                  f"{row[tag + '_library']:.4f} ms by events, "
                  f"{row[tag + '_library_device']:.4f} ms on the device", flush=True)
        row["unaligned_over_aligned"] = row["unaligned"] / row["aligned"]
        print(f"L={L} n_tiles={n_tiles}: unaligned/aligned = "
              f"{row['unaligned_over_aligned']:.3f}x", flush=True)
        out[f"L{L}_t{n_tiles}"] = row
        del src
    return out


if __name__ == "__main__":
    main()
