"""The port's probe kernels (plain versions, on the CPU) against the JAX
probes' Pallas kernels run in interpret mode, on the same numpy inputs.

* window copy: bitwise, from 128-aligned starts and from odd starts;
* span density: within rtol 1e-5 of max |out| for the variants A, B and C.
  The float32 sums run in another order (the JAX kernel sums per 128-lane
  chunk into a (qb, 128) accumulator, then across lanes; the plain version
  sums each query's lanes in one reduction)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tools import span_dma_probe as j_span
from tools import unaligned_probe as j_copy

from pi_sph_fluid_tpu_torch.tools import span_dma_probe as t_span
from pi_sph_fluid_tpu_torch.tools import unaligned_probe as t_copy

torch.set_num_threads(1)

L_COPY, N_TILES = 4096, 3
N_LAYOUT, L_SPAN, TQ, QB = 256, 2048, 64, 16


@pytest.mark.parametrize("form", ["aligned", "unaligned"])
def test_window_copy_plain_equals_jax_bitwise(form):
    src, al, un = t_copy.make_starts(L_COPY, N_TILES, seed=4)
    starts = al if form == "aligned" else un
    pad = (-N_TILES) % 8 + 8
    want = j_copy.window_copy(jnp.asarray(np.pad(starts, ((0, pad), (0, 0)))),
                              jnp.asarray(src), N_TILES, form == "aligned",
                              interpret=True)
    got = t_copy.window_copy(torch.from_numpy(starts), torch.from_numpy(src),
                             aligned=form == "aligned")
    assert got.shape == (N_TILES, t_copy.NB, t_copy.K, t_copy.CAP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if form == "unaligned":
        assert (starts % 128 != 0).all()


def _jax_span(q, src, ws_pad, spans, span_cap):
    """The GridSpec of `span_dma_probe.run_variant:104-121` around the
    probe's own kernel, in interpret mode."""
    nqb, n_tiles = TQ // QB, N_LAYOUT // TQ
    grid_spec = pl.GridSpec(
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((8, nqb, spans), lambda i: (i // 8, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((8, nqb, spans), lambda i: (i // 8 + 1, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((TQ, 8), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.HBM),
        ],
        out_specs=pl.BlockSpec((TQ, 1), lambda i: (i, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[
            pltpu.VMEM((2, nqb, spans, 8, span_cap), jnp.float32),
            pltpu.SemaphoreType.DMA((2, nqb, spans)),
        ],
    )
    kernel = functools.partial(j_span._kernel, nqb=nqb, qb=QB, spans=spans,
                               span_cap=span_cap, n_tiles=n_tiles)
    ws = jnp.asarray(ws_pad)
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((N_LAYOUT, 1), jnp.float32),
        grid_spec=grid_spec, interpret=True)(ws, ws, jnp.asarray(q), jnp.asarray(src)))


@pytest.mark.parametrize("variant", sorted(t_span.VARIANTS))
def test_span_density_plain_matches_jax(variant):
    spans, span_cap = t_span.VARIANTS[variant]
    rng = np.random.default_rng(7)
    n_tiles, nqb = N_LAYOUT // TQ, TQ // QB
    # positions inside a unit-scale box so that most pair lanes are within
    # the support r < 1 and the sums are far from zero
    src = rng.uniform(0.0, 2.0, (8, 2 * L_SPAN)).astype(np.float32)
    q = rng.uniform(0.0, 2.0, (N_LAYOUT, 8)).astype(np.float32)
    # the JAX kernel's SMEM blocks reach row (n_tiles // 8 + 2) * 8; the
    # rows past n_tiles serve only its next-tile prefetch
    rows = (n_tiles // 8 + 2) * 8
    ws = (rng.integers(0, (2 * L_SPAN - span_cap) // 128, (rows, nqb, spans))
          * 128).astype(np.int32)
    want = _jax_span(q, src, ws, spans, span_cap)
    got = t_span.span_density(torch.from_numpy(q), torch.from_numpy(src),
                              torch.from_numpy(ws), spans, span_cap, TQ, QB)
    assert got.shape == (N_LAYOUT, 1)
    scale = float(np.abs(want).max())
    assert scale > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_probe_costs_count_distinct_columns():
    """The bound's bytes count each distinct source column once: two equal
    windows cost one window's columns."""
    src = torch.zeros((8, 1024))
    starts = torch.tensor([[0, 0], [256, 300]], dtype=torch.int32)
    c = t_copy.copy_cost(starts, src)
    assert c["source_columns"] == 128 + 172
    assert c["bytes"] == 300 * 8 * 4 + 4 * (4 + 8 * 128 * 4)
    assert c["bound_by"] == "bytes" and c["flops"] == 0
    q = torch.zeros((256, 8))
    w_s = torch.zeros((1, 16, 1), dtype=torch.int32)
    s = t_span.span_cost(q, torch.zeros((8, 2048)), w_s, 1, 512)
    assert s["source_columns"] == 512
    assert s["flops"] == 256 * 512 * 14 and s["bound_by"] == "operations"


def test_wrappers_refuse_bad_inputs():
    src = torch.zeros((8, 512))
    with pytest.raises(ValueError):
        t_copy.window_copy(torch.zeros((2, 16), dtype=torch.int64), src)
    with pytest.raises(ValueError):
        t_copy.window_copy(torch.zeros((2, 16), dtype=torch.int32), src, cap=6)
    q = torch.zeros((300, 8))
    with pytest.raises(ValueError):
        t_span.span_density(q, torch.zeros((8, 1024)),
                            torch.zeros((1, 16, 1), dtype=torch.int32), 1, 512)
