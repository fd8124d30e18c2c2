"""The window engine's relayout: CUDA kernels and their plain version
(port of `pi_sph_fluid_tpu/models/engine_v3.py:130-171`).

A relayout sorts the packed state by cell into the qb-quantised row layout
and builds what the window kernels read of it (``TripleCtx``):

* ``relayout_plain``: the PyTorch chain, triple.py's functions as the JAX
  package's relayout composes them: keys, a stable argsort, a bincount CSR,
  ``build_frame`` (its scatter-max + cummax row map), the two row gathers,
  the layout's cells, ``block_windows``, ``start_grid`` and
  ``block_spans``;
* ``relayout``: the same outputs, bit for bit, from four hand-written
  kernels (csrc/relayout_kernels.cu) around the same argsort on a CUDA
  tensor; the plain version on a CPU tensor; a raise on any other device.

The relayout replaces no TPU kernel (the JAX relayout is jnp code that XLA
fuses).  The kernels exist because on the card the plain chain is bound by
its ~150 launches and its four host synchronisations (the bincount's min and
max, two boolean masks), and its cummax runs as one single-row scan over
every layout slot; the kernels launch four times around the sort and never
wait for the host.  Each CUDA relayout counts once in utils/tracer.py's
``kernel.relayout.launches``.
"""

from __future__ import annotations

import functools

import torch

from ...config import SPHConfig
from ...utils.tracer import tracer
from ..grid import cell_ids, csr_starts, inv_cell_length
from .triple import (TripleCtx, TripleSpec, block_spans, block_windows,
                     build_frame, start_grid)
from .window_kernels import _check, _launch

__all__ = ["relayout", "relayout_plain"]

_I32 = torch.int32


def relayout_plain(spec: TripleSpec, cfg: SPHConfig, packed: torch.Tensor,
                   b_cell_starts: torch.Tensor, b_grid: torch.Tensor,
                   inert_row: torch.Tensor):
    """(packed_new, ctx, overflow, order) of the PyTorch chain on any
    device: layout slot j holds input row ``order[ctx.layout_src[j]]``
    where ``layout_src[j] < n_layout``, else ``inert_row``."""
    x, y, m = packed[:, 0], packed[:, 1], packed[:, 4]
    keys = torch.where(m > 0, cell_ids(x, y, cfg),
                       torch.full_like(m, cfg.n_cells, dtype=_I32))
    order = torch.argsort(keys, stable=True)
    cell_starts = csr_starts(keys, cfg.n_cells + 2)
    layout_src, T, row_shift = build_frame(spec, cfg, cell_starts, b_cell_starts)
    packed_sorted = torch.cat([packed[order], inert_row])
    packed_new = packed_sorted[layout_src.long()]
    live = packed_new[:, 4] > 0
    cells = torch.where(live, cell_ids(packed_new[:, 0], packed_new[:, 1], cfg),
                        torch.full_like(live, cfg.n_cells, dtype=_I32))
    w_start, w_len, flen, overflow = block_windows(spec, cfg, cells, T)
    f_grid = start_grid(cfg, cell_starts, row_shift)
    spans = block_spans(spec, cfg, cells, f_grid, b_grid)
    ctx = TripleCtx(layout_src=layout_src, start_grid=f_grid,
                    w_start=w_start, w_len=w_len, flen=flen, T=T,
                    overflow=overflow, spans=spans)
    return packed_new, ctx, overflow, order


@functools.lru_cache(maxsize=None)
def _ws_ints(n_rows: int, n_cols: int, seg_q: int) -> int:
    """int32 entries of the kernels' workspace, as the library lays it out."""
    from ._build import library

    return library("relayout_kernels")[0].relayout_ws_ints(n_rows, n_cols, seg_q)


def relayout(spec: TripleSpec, cfg: SPHConfig, packed: torch.Tensor,
             b_cell_starts: torch.Tensor, b_grid: torch.Tensor,
             inert_row: torch.Tensor):
    """``relayout_plain``'s (packed_new, ctx, overflow, order) from the
    (n_layout, 8) packed state, the static boundary CSR (n_cells + 1,) and
    start grid (n_rows * (m + 1),) and the (1, 8) inert row: the kernels on
    CUDA tensors, the plain version on CPU ones."""
    dev = packed.device
    n_rows, m, n_cells = cfg.n_cell_rows, cfg.n_cell_cols, cfg.n_cells
    _check("packed", packed, (spec.n_layout, 8), torch.float32, dev)
    _check("b_cell_starts", b_cell_starts, (n_cells + 1,), torch.int32, dev)
    _check("b_grid", b_grid, (n_rows * (m + 1),), torch.int32, dev)
    _check("inert_row", inert_row, (1, 8), torch.float32, dev)
    if dev.type == "cpu":
        return relayout_plain(spec, cfg, packed, b_cell_starts, b_grid, inert_row)
    if dev.type != "cuda":
        raise ValueError(f"no relayout kernel for device {dev}")
    if inert_row.data_ptr() % 16:
        raise ValueError("inert_row must be 16-byte aligned")
    lib = "relayout_kernels"
    fn, stream = _launch("relayout_keys", dev, lib)
    n_layout, inv = spec.n_layout, inv_cell_length(cfg)
    ws = torch.empty(_ws_ints(n_rows, m, spec.seg_q), dtype=_I32, device=dev)
    keys = torch.empty(n_layout, dtype=_I32, device=dev)
    err = fn(packed.data_ptr(), keys.data_ptr(), ws.data_ptr(), ws.numel(),
             n_layout, n_rows, m, inv, stream)
    if err:
        raise RuntimeError(f"relayout_keys kernel launch failed: CUDA error {err}")
    order = torch.argsort(keys, stable=True)
    n_blocks = n_layout // spec.qb
    packed_new = torch.empty_like(packed)
    layout_src = torch.empty(n_layout, dtype=_I32, device=dev)
    f_grid = torch.empty(n_rows * (m + 1), dtype=_I32, device=dev)
    T = torch.empty((n_cells + 1, 8), dtype=_I32, device=dev)
    w_start = torch.empty((spec.n_tiles, spec.nqb), dtype=_I32, device=dev)
    w_len = torch.empty((spec.n_tiles, spec.nqb), dtype=_I32, device=dev)
    spans = torch.empty((n_blocks, spec.n_spans, 2), dtype=_I32, device=dev)
    overflow = torch.empty((), dtype=_I32, device=dev)
    fn = _launch("relayout_frame", dev, lib)[0]
    err = fn(packed.data_ptr(), order.data_ptr(), inert_row.data_ptr(),
             b_cell_starts.data_ptr(), b_grid.data_ptr(), ws.data_ptr(),
             packed_new.data_ptr(), layout_src.data_ptr(), f_grid.data_ptr(),
             T.data_ptr(), w_start.data_ptr(), w_len.data_ptr(), spans.data_ptr(),
             overflow.data_ptr(), ws.numel(), n_layout, n_rows, m, spec.qb, spec.cap,
             spec.seg_q, spec.n_spans, spec.L, inv, stream)
    if err:
        raise RuntimeError(f"relayout_frame kernel launch failed: CUDA error {err}")
    tracer.count("kernel.relayout.launches")  # one a relayout, not a kernel launch
    ctx = TripleCtx(layout_src=layout_src, start_grid=f_grid, w_start=w_start,
                    w_len=w_len, flen=w_len, T=T, overflow=overflow, spans=spans)
    return packed_new, ctx, overflow, order
