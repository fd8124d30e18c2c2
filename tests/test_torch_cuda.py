"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Skips without a card.  This file imports no JAX, so on the GPU machine it
runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pi_sph_fluid_tpu_torch import SPHConfig, build_drop_scene, prepare_boundary
from pi_sph_fluid_tpu_torch.models.engine_v3 import PackedSim, WindowEngine
from pi_sph_fluid_tpu_torch.ops.window import relayout as rl
from pi_sph_fluid_tpu_torch.ops.window import window_kernels as wk
from pi_sph_fluid_tpu_torch.ops.window.triple import Frame, TripleSpec
from pi_sph_fluid_tpu_torch.render import metaballs_window as mw
from pi_sph_fluid_tpu_torch.tools import span_dma_probe as sp
from pi_sph_fluid_tpu_torch.tools import unaligned_probe as up
from pi_sph_fluid_tpu_torch.utils.profiling import pool_engine
from pi_sph_fluid_tpu_torch.utils.tracer import tracer

G = (0.0, -9.81)


def _launches(*kernels) -> tuple:
    """The launch counters (utils/tracer.py) of the named window kernels."""
    return tuple(tracer.counters.get(f"kernel.{k}.launches", 0) for k in kernels)


@pytest.fixture(params=[(256, 1.0), (1024, 0.6), (96, 1.0)],
                ids=["cap256", "cap1024_dense", "cap96"])
def pool_frame(request):
    """One relayout of a 20k pool with seeded random velocities, so that
    the viscosity term is live; at the default cap; at the live run's 1024
    with the pool squeezed to 0.6 of its width and height, so that the
    windows are long enough to be staged in several chunks; and at a cap
    that truncates windows (the kernels then compute the first cap lanes in
    span order, as the plain versions do)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    cap, squeeze = request.param
    eng, fluid = pool_engine(20_000, "cuda", cap=cap)
    rng = np.random.default_rng(3)
    fluid = fluid._replace(x=fluid.x * squeeze, y=fluid.y * squeeze, **{
        k: torch.from_numpy(rng.normal(0.0, 0.5, fluid.n).astype(np.float32)).cuda()
        for k in ("u", "v")})
    pk, ctx, ov = eng._relayout(eng._initial_packed(fluid))
    assert (int(ov) > 0) == (cap == 96)
    assert (int(ctx.w_len.max()) > 256) == (squeeze < 1.0)   # one chunk: 256 lanes
    return eng, pk, ctx


@pytest.mark.cuda
def test_density_kernel_matches_plain(pool_frame):
    """rho rtol 1e-6 (FMA contraction and another summation order); the
    copied geo8 columns bitwise."""
    eng, pk, ctx = pool_frame
    args = (pk, eng._b_geo_d, ctx.spans, eng.cfg, eng.spec)
    before = tracer.counters.get("kernel.density.launches", 0)
    g8k, rpk = wk.density_window(*args)
    g8p, rpp = wk.density_window_plain(*args)
    torch.cuda.synchronize()
    assert tracer.counters.get("kernel.density.launches", 0) == before + 1
    torch.testing.assert_close(rpk[:, 0], rpp[:, 0], rtol=1e-6, atol=0)
    assert torch.equal(g8k[:, [0, 1, 2, 3, 4, 7]], g8p[:, [0, 1, 2, 3, 4, 7]])


@pytest.mark.cuda
@pytest.mark.parametrize("half_dt_frac,damp", [(0.5, 0.97), (0.0, 1.0)])
def test_forces_kernel_matches_plain(pool_frame, half_dt_frac, damp):
    """acc rtol 2e-5 / atol 2e-4, as the module gates; u' and v' within
    half_dt times that bound plus 2 ulp; the copied pk_next columns
    bitwise; the priming pass (half_dt = 0, damp = 1) leaves u and v
    bitwise unchanged."""
    eng, pk, ctx = pool_frame
    g8, rp = wk.density_window_plain(pk, eng._b_geo_d, ctx.spans, eng.cfg, eng.spec)
    half_dt = float(np.float32(half_dt_frac * eng.cfg.dt))
    args = (pk, g8, rp, eng._b_geo_f, ctx.spans, G, eng.cfg, eng.spec,
            half_dt, damp)
    pkk, acck = wk.forces_window(*args)
    pkp, accp = wk.forces_window_plain(*args)
    torch.cuda.synchronize()
    # the squeezed pool's pressures are ~1e4 times the settled pool's and
    # cancel in the sum, so its absolute tolerance scales with max |acc|
    atol = max(2e-4, 1e-6 * float(accp.abs().max()))
    torch.testing.assert_close(acck, accp, rtol=2e-5, atol=atol)
    bound = (half_dt * (atol + 2e-5 * accp.abs())
             + 2 * torch.finfo(torch.float32).eps * pkp[:, 2:4].abs())
    assert bool(((pkk[:, 2:4] - pkp[:, 2:4]).abs() <= bound).all())
    assert torch.equal(pkk[:, [0, 1, 4, 5, 6, 7]], pkp[:, [0, 1, 4, 5, 6, 7]])
    if half_dt_frac == 0.0:
        assert torch.equal(pkk[:, 2:4], pk[:, 2:4])


@pytest.mark.cuda
@pytest.mark.parametrize("poison", ["cp", "position"])
def test_forces_kernel_non_finite_candidate(poison):
    """What a non-finite candidate row does to the forces kernel, which
    does a lane's full arithmetic only within reach (r^2 < (2H)^2 widened by
    1e-4; a non-finite r^2 counts as in reach).  A NaN cp (a dead pressure)
    poisons every real query within 2H of the row and no query beyond it:
    those keep, bitwise, the acc of the clean input, where the TPU kernel
    and the plain version (NaN * 0 on every lane of the window) poison the
    whole window.  A NaN position poisons exactly the queries it poisons in
    the plain version: every real query of a block whose spans hold the
    row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    eng, fluid = pool_engine(5_000, "cuda")
    pk, ctx, ov = eng._relayout(eng._initial_packed(fluid))
    assert int(ov) == 0
    g8, rp = wk.density_window_plain(pk, eng._b_geo_d, ctx.spans, eng.cfg, eng.spec)
    real = pk[:, 4] > 0.0
    mid = pk[real, 0:2].median(0).values
    dist = torch.where(real, (pk[:, 0:2] - mid).square().sum(1), torch.inf)
    j = int(dist.argmin())
    r = (pk[:, 0:2] - pk[j, 0:2]).square().sum(1).sqrt()
    two_h = 2.0 * eng.cfg.h

    def run(fn, pk_, g8_):
        out = fn(pk_, g8_, rp, eng._b_geo_f, ctx.spans, G, eng.cfg, eng.spec,
                 eng.half_dt, 0.97)[1]
        torch.cuda.synchronize()
        return out

    clean = run(wk.forces_window, pk, g8)
    assert bool(torch.isfinite(clean).all())
    pk_bad, g8_bad = pk.clone(), g8.clone()
    if poison == "cp":
        g8_bad[j, 5] = torch.nan
    else:
        pk_bad[j, 0] = g8_bad[j, 0] = torch.nan
    got = torch.isfinite(run(wk.forces_window, pk_bad, g8_bad)).all(1)
    want = torch.isfinite(run(wk.forces_window_plain, pk_bad, g8_bad)).all(1)
    assert not bool(want[j]) and not bool(got[j])
    assert bool((got | ~want).all())        # the kernel poisons no more
    if poison == "position":
        assert torch.equal(got, want)
        return
    near, far = real & (r < 0.999 * two_h), r > 1.001 * two_h
    assert int(near.sum()) > 4 and not bool(got[near].any())
    assert bool(got[far].all())
    assert int((far & ~want).sum()) > 0     # where the plain version differs
    acc_bad = run(wk.forces_window, pk_bad, g8_bad)
    assert torch.equal(acc_bad[far], clean[far])


@pytest.mark.cuda
def test_forces_kernel_launches_are_bitwise_repeatable(pool_frame):
    """Two launches of the forces kernel on the same inputs give the same
    acc and pk_next bit for bit: each thread adds its lanes in lane order
    and the group's shuffle tree is fixed, whatever the warps' timing."""
    eng, pk, ctx = pool_frame
    g8, rp = wk.density_window(pk, eng._b_geo_d, ctx.spans, eng.cfg, eng.spec)
    args = (pk, g8, rp, eng._b_geo_f, ctx.spans, G, eng.cfg, eng.spec,
            eng.half_dt, 0.97)
    one, two = wk.forces_window(*args), wk.forces_window(*args)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# Hand-built windows of the forces kernel (G = 4 threads a query, lane j
# to thread j mod 4; a thread's lanes of a 256-lane chunk are tested for
# reach 8 at a time and walked two at a time): {case: (window lanes, lanes
# in reach, lane whose x is NaN or None)}
HAND_WINDOWS = {
    # threads 0..3 hold 2, 3, 0 and 5 lanes in reach
    "odd_count": (40, (0, 4, 1, 5, 9, 3, 7, 11, 15, 19), None),
    # threads 2 and 3 hold none
    "thread_without": (60, (0, 4, 1), None),
    # lane 255 is thread 3's 64th lane of the chunk, the mask's top bit
    "last_of_chunk": (256, (255,), None),
    # two chunks; lanes in reach on both sides of a thread's test batch
    # (thread g's lanes g + 28 and g + 32) and of the chunk's end
    "straddle": (400, (28, 32, 29, 33, 37, 30, 34, 251, 252, 255, 256, 259,
                       284, 288, 399), None),
    # lane 9 (thread 1's third) at x = NaN beside finite lanes in reach
    "nan_position": (40, (0, 4, 1, 5, 13, 3), 9),
}


def _hand_window(n_lanes, near, nan_lane, device):
    """forces_window's arguments for one hand-built window: block 0's 16
    queries within 0.03 H of a point P, its window one fluid span of
    ``n_lanes`` rows from row 64; lane j lies 0.3-1.2 H above and right of
    P (in reach of every query, no term cancelling another) if j is in
    ``near``, else 3-4 H away.  The other blocks' spans are empty."""
    cfg = SPHConfig()
    spec = TripleSpec(tq=256, qb=16, cap=1024, seg_q=2, n_layout=1024, L=0)
    rng = np.random.default_rng(11)
    h, p0 = cfg.h, np.float32([1.0, 1.0])
    pk = np.zeros((spec.n_layout, 8), np.float32)
    pk[:, 4] = cfg.particle_mass
    pk[:, 5:7] = (cfg.rho_0, 1000.0)
    pk[:, 2:4] = rng.normal(0.0, 0.5, (spec.n_layout, 2))
    pk[:16, 0:2] = p0 + rng.uniform(-0.02, 0.02, (16, 2)) * h
    rows = np.arange(n_lanes)
    off = np.where(np.isin(rows, near)[:, None],
                   rng.uniform(0.3, 0.85, (n_lanes, 2)),
                   rng.uniform(3.0, 4.0, (n_lanes, 2)))
    pk[64:64 + n_lanes, 0:2] = p0 + off * h
    if nan_lane is not None:
        pk[64 + nan_lane, 0] = np.nan
    geo8 = pk.copy()
    geo8[:, 5:8] = (1e-3, 0.5 * cfg.rho_0, 0.5)
    spans = np.zeros((spec.n_layout // spec.qb, spec.n_spans, 2), np.int32)
    spans[0, 0] = (64, n_lanes)
    b_geo_f = np.zeros((4, 8), np.float32)
    b_geo_f[:, 7] = 1.0
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (t(pk), t(geo8), t(pk[:, 5:7].copy()), t(b_geo_f), t(spans), G, cfg,
            spec, 0.5 * cfg.dt, 0.97)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(HAND_WINDOWS))
def test_forces_kernel_hand_windows(case):
    """Windows that put lanes in reach where the kernel's walk over a
    thread's lanes turns: an odd count, none, the chunk's last lane alone,
    across a test batch and a chunk, and a NaN position beside finite lanes
    (it poisons every query of its window, as in the plain version).  acc
    within the module's rtol 2e-5 / atol 2e-4 of the plain version (NaN
    where it is NaN), the copied pk_next columns bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    args = _hand_window(*HAND_WINDOWS[case], "cuda")
    pkk, acck = wk.forces_window(*args)
    pkp, accp = wk.forces_window_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(acck, accp, rtol=2e-5, atol=2e-4, equal_nan=True)
    torch.testing.assert_close(pkk[:, [0, 1, 4, 5, 6, 7]], pkp[:, [0, 1, 4, 5, 6, 7]],
                               rtol=0, atol=0, equal_nan=True)
    poisoned = ~torch.isfinite(accp).all(1)
    assert int(poisoned.sum()) == (16 if HAND_WINDOWS[case][2] is not None else 0)


@pytest.mark.cuda
def test_span_kernels_take_garbage_spans_and_small_blocks():
    """Spans that reach outside their arrays are clamped, never read past
    (no fault on synchronize), and qb = 8 with seg_q = 3 (64 threads a
    block, 10 spans) agrees with the plain versions like the default."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    eng, fluid = pool_engine(5_000, "cuda", tq=32, qb=8, seg_q=3)
    pk, ctx, ov = eng._relayout(eng._initial_packed(fluid))
    assert int(ov) == 0 and ctx.spans.shape[1] == 10
    spans = ctx.spans.clone()
    nb = eng._b_geo_d.shape[0]
    spans[0, 0] = torch.tensor([-5, 7])
    spans[1, 1] = torch.tensor([eng.spec.n_layout - 2, 9])
    spans[2, 6] = torch.tensor([nb - 1, 1 << 30])
    spans[3, 7] = torch.tensor([1 << 30, 4])
    spans[4, 2] = torch.tensor([3, -8])
    for sp_ in (ctx.spans, spans):
        g8k, rpk = wk.density_window(pk, eng._b_geo_d, sp_, eng.cfg, eng.spec)
        g8p, rpp = wk.density_window_plain(pk, eng._b_geo_d, sp_, eng.cfg, eng.spec)
        pkk, acck = wk.forces_window(pk, g8p, rpp, eng._b_geo_f, sp_, G, eng.cfg,
                                     eng.spec, eng.half_dt, 0.97)
        pkp, accp = wk.forces_window_plain(pk, g8p, rpp, eng._b_geo_f, sp_, G,
                                           eng.cfg, eng.spec, eng.half_dt, 0.97)
        torch.cuda.synchronize()
        torch.testing.assert_close(rpk[:, 0], rpp[:, 0], rtol=1e-6, atol=0)
        torch.testing.assert_close(acck, accp, rtol=2e-5, atol=2e-4)


def _assert_relayout_matches_plain(eng, packed):
    """The engine's relayout of ``packed`` (the kernels) against the plain
    chain on the same CUDA tensor, bitwise in every output: the packed state
    (as bits), order, each TripleCtx field and the overflow.  The kernels'
    relayout must not wait for the host once (the sync debug mode raises on
    any synchronising call) and counts one ``kernel.relayout.launches``.
    Returns the kernels' (packed_new, ctx, overflow, order)."""
    fixed = (eng.b_cell_starts, eng._b_grid, eng._inert_row)
    want = rl.relayout_plain(eng.spec, eng.cfg, packed, *fixed)
    eng._relayout_order(packed)        # the library's build and a first call
    torch.cuda.synchronize()
    before = tracer.counters.get("kernel.relayout.launches", 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eng._relayout_order(packed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tracer.counters.get("kernel.relayout.launches", 0) == before + 1
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[3], want[3]) and torch.equal(got[2], want[2])
    for f in want[1]._fields:
        a, b = getattr(got[1], f), getattr(want[1], f)
        assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape, f
        assert torch.equal(a, b), f
    return got


@pytest.mark.cuda
def test_relayout_kernels_match_plain_on_pool(pool_frame):
    """The pool fixture's layout-order state (its three caps; at cap 96 the
    windows overflow) relaid out by the kernels and by the plain chain."""
    eng, pk, ctx = pool_frame
    got = _assert_relayout_matches_plain(eng, pk)
    assert int(got[2]) == int(ctx.overflow)
    assert torch.equal(got[0], pk)     # a fresh layout moves no row


def _drop_engine(**kw):
    cfg = SPHConfig()
    fluid, braw = build_drop_scene(cfg, "cuda")
    b, bg = prepare_boundary(braw, cfg)
    return WindowEngine(cfg, b, bg, fluid.n, "cuda", **kw), fluid


def _relayout_input(case: str):
    """(engine, packed input, what the case must show) of a relayout case."""
    if case == "drop_269":
        eng, fluid = _drop_engine()
        return eng, eng._initial_packed(fluid), None
    if case == "drop_small_blocks":
        eng, fluid = _drop_engine(tq=32, qb=8, cap=256, seg_q=3)
        return eng, eng._initial_packed(fluid), None
    if case == "trailing_rows_empty":
        eng, fluid = pool_engine(20_000, "cuda")     # water to 0.85 of the height
        return eng, eng._initial_packed(fluid), "trailing"
    if case == "pads_among_live":
        eng, fluid = pool_engine(20_000, "cuda")
        pk = eng._initial_packed(fluid)
        pk[::7, 4] = 0.0
        # and the input not in layout order
        perm = torch.randperm(pk.shape[0], generator=torch.Generator().manual_seed(5))
        return eng, pk[perm.cuda()].contiguous(), None
    if case == "cap_too_small":
        eng, fluid = pool_engine(20_000, "cuda", cap=32)
        return eng, eng._initial_packed(fluid), "overflow"
    if case == "tank_1m":
        eng, fluid = pool_engine(1_000_000, "cuda")
        return eng, eng._initial_packed(fluid), None
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["drop_269", "drop_small_blocks",
                                  "trailing_rows_empty", "pads_among_live",
                                  "cap_too_small", "tank_1m"])
def test_relayout_kernels_match_plain(case):
    """The relayout kernels against the plain chain from an initial state:
    the 269 drop (empty grid rows under and over it), the same with qb = 8
    and seg_q = 3, a 20k pool (its last grid rows, above the water, hold no
    fluid), the pool with every seventh row a pad and the rows
    shuffled, a cap the windows overflow (the overflow counts equal), and
    the ~1M pool lattice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    eng, pk, shows = _relayout_input(case)
    got = _assert_relayout_matches_plain(eng, pk)
    ctx, ov = got[1], int(got[2])
    if shows == "overflow":
        assert ov > 0
    else:
        assert ov == 0
    if shows == "trailing":
        m = eng.cfg.n_cell_cols
        last = ctx.start_grid.view(eng.cfg.n_cell_rows, m + 1)[-3:]
        assert bool((last[:, 0] == last[:, m]).all())   # no fluid in the last rows


@pytest.mark.cuda
def test_relayout_counter_equals_relayout_spans():
    """Over a prime, 4 exact ticks and a sticky group of 4 on the card,
    ``kernel.relayout.launches`` rises by exactly one for each of the
    tracer's ``stepper.relayout`` spans (1 + 4 + 1), and a carried tick of
    the sticky group waits for the host not once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    eng, fluid = pool_engine(5_000, "cuda")
    g = np.tile(np.float32(G), (4, 1))
    eng.make_multi_step()(eng.prime(fluid, G), g)      # builds, warms up
    torch.cuda.synchronize()
    was_on = tracer.on
    tracer.enable()
    n_spans = len(tracer.spans)
    before = tracer.counters.get("kernel.relayout.launches", 0)
    try:
        sim = eng.prime(fluid, G)
        sim, _ = eng.make_multi_step()(sim, g)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sim, st = eng.make_multi_step(resort_every=4)(sim, g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    finally:
        if not was_on:
            tracer.disable()
    spans = [sp_ for sp_ in tracer.spans[n_spans:] if sp_.name == "stepper.relayout"]
    assert len(spans) == 6
    assert tracer.counters["kernel.relayout.launches"] - before == len(spans)
    assert int(st.neighbor_overflow.max()) == 0 and int(st.stale.max()) == 0


def _pool_frame_for_render():
    """The 20k pool with random velocities after one exact tick, and the
    tick's relayout frame."""
    eng, fluid = pool_engine(20_000, "cuda")
    rng = np.random.default_rng(3)
    fluid = fluid._replace(**{
        k: torch.from_numpy(rng.normal(0.0, 0.5, fluid.n).astype(np.float32)).cuda()
        for k in ("u", "v")})
    sim, st, frame = eng.make_multi_step(return_frame=True)(
        eng.prime(fluid, G), np.float32([G]))
    return eng, sim, frame


def _assert_field_close(rend, args):
    before = tracer.counters.get("kernel.field.launches", 0)
    fk = mw.field_window(*args)
    fp = mw.field_window_plain(*args)
    torch.cuda.synchronize()
    assert tracer.counters.get("kernel.field.launches", 0) == before + 1
    fk, fp = fk * rend.field_scale, fp * rend.field_scale
    torch.testing.assert_close(fk, fp, rtol=1e-5, atol=5e-5)
    confident = (fp - 1.0).abs() > 1e-3
    assert torch.equal((fk >= 1.0)[confident], (fp >= 1.0)[confident])
    return fk


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 256])
def test_field_kernel_matches_plain(rows):
    """The field kernel against its plain version on the 20k pool's frame
    (random velocities, one exact tick), through the renderer's own inputs
    (the packed state, the frame's start grid, the static index pairs): the
    scaled field within rtol 1e-5 / atol 5e-5 (test_render_window.py:60), lit
    pixels identical wherever |field - 1| > 1e-3, one launch counted; and
    the same through the self-relayout inputs of ``field``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    eng, sim, frame = _pool_frame_for_render()
    rend = mw.WindowRenderer(eng, rows, 128)
    fk = _assert_field_close(rend, (rend.q_packed, sim.packed, frame.start_grid,
                                    rend.reuse_span_idx, eng.cfg, rend.reuse_spec))
    assert float(fk.max()) > 1.0
    f_frame, ov = rend.field_from_frame(sim, frame)
    f_self, ov_self = rend.field(sim)
    assert int(ov) == int(ov_self) == 0
    torch.testing.assert_close(f_frame, f_self, rtol=1e-5, atol=5e-5)


@pytest.mark.cuda
def test_field_kernel_truncates_and_clamps():
    """A cap that truncates windows (the kernel keeps the first cap fluid
    lanes in span order, as the plain version does, through several staged
    chunks or less than one) and a start grid with garbage entries, which is
    clamped and never read past (no fault on synchronize)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    eng, fluid = pool_engine(20_000, "cuda")
    # squeezed to half its width and height: four times as dense, so that
    # the pixel windows span several staged chunks
    fluid = fluid._replace(x=fluid.x * 0.5, y=fluid.y * 0.5)
    pk, ctx, _ = eng._relayout(eng._initial_packed(fluid))
    zero = torch.zeros_like(pk[:, 0])
    sim = PackedSim(packed=pk, ids=pk[:, 7].int(), au=zero, av=zero)
    frame = Frame(ctx.start_grid, ctx.T)
    rend = mw.WindowRenderer(eng, 64, 128)
    full = rend.reuse_spec
    assert full.cap > 300
    for cap in (24, 300, full.cap):
        spec = full._replace(cap=cap)
        fk = _assert_field_close(rend, (rend.q_packed, pk, frame.start_grid,
                                        rend.reuse_span_idx, eng.cfg, spec))
        rend.reuse_spec = spec
        if cap < full.cap:
            assert int(rend.field_from_frame(sim, frame)[1]) > 0
        assert float(fk.max()) > 0
    grid = frame.start_grid.clone()
    grid[::7] = torch.tensor([-5, 1 << 30, -(1 << 31), (1 << 31) - 1, 3, 1 << 20, 0],
                             dtype=torch.int32, device="cuda").repeat(
        -(-grid[::7].numel() // 7))[:grid[::7].numel()]
    idx = rend.reuse_span_idx.clone()
    idx[5] = torch.tensor([[-3, 1 << 30]] * idx.shape[1], dtype=torch.int32)
    _assert_field_close(rend, (rend.q_packed, pk, grid, idx, eng.cfg, full))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["aligned", "unaligned", "broken_promise"])
def test_window_copy_kernel_matches_plain(form):
    """Bitwise, from 128-aligned starts (16-byte loads), from odd starts
    (4-byte loads), and from odd starts under the aligned promise (the
    kernel's 4-byte fallback); an L that is not a multiple of 4 included;
    one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    for L, n_tiles in ((1 << 14, 16), ((1 << 14) + 3, 5)):
        src, al, un = up.make_starts(L, n_tiles, seed=1)
        starts = torch.from_numpy(al if form == "aligned" else un).cuda()
        src = torch.from_numpy(src).cuda()
        before = tracer.counters.get("probe.window_copy.launches", 0)
        got = up.window_copy(starts, src, aligned=form != "unaligned")
        want = up.window_copy_plain(starts, src)
        torch.cuda.synchronize()
        assert tracer.counters.get("probe.window_copy.launches", 0) == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(sp.VARIANTS))
def test_span_density_kernel_matches_plain(variant):
    """Within rtol 1e-5 of max |out| (another summation order, and nvcc's
    FMA contraction); one launch counted; w_s rows past n_tiles unread."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    spans, span_cap = sp.VARIANTS[variant]
    q, src, w_s = sp.make_inputs(8192, 20_000, spans, span_cap, "cuda", seed=2)
    w_s = torch.cat([w_s, torch.full_like(w_s[:8], -(1 << 30))])
    before = tracer.counters.get("probe.span_density.launches", 0)
    got = sp.span_density(q, src, w_s, spans, span_cap)
    want = sp.span_density_plain(q, src, w_s, spans, span_cap)
    torch.cuda.synchronize()
    assert tracer.counters.get("probe.span_density.launches", 0) == before + 1
    scale = float(want.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("spans,span_cap,qb,tq", [
    (3, 2048, 16, 256), (1, 8192, 16, 256), (5, 100, 8, 256), (2, 256, 32, 256),
    (2, 256, 1, 256), (3, 100, 5, 160), (1, 512, 31, 248)])
def test_span_density_kernel_any_lane_count(spans, span_cap, qb, tq):
    """The staged chunk is fixed, so any spans x span_cap launches: past
    the 4096 lanes a block's shared memory once held, span lengths that are
    no multiple of the chunk, and other query-block sizes, odd ones and a
    single query included (the last thread group then keeps one query)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q, src, w_s = sp.make_inputs(8 * tq, 20_000, spans, span_cap, "cuda", tq, qb, seed=5)
    got = sp.span_density(q, src, w_s, spans, span_cap, tq, qb)
    want = sp.span_density_plain(q, src, w_s, spans, span_cap, tq, qb)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.cuda
def test_window_domain_launches_both_kernels_once_a_slab():
    """A 3-slab WindowDomain of a 20k pool on the card: each step launches
    the density and the forces kernel once a slab (no plain fallback), and
    5 steps land within test_parallel_window.py's gates (1e-6 m, 1e-5 m/s)
    of the same domain on the CPU, whose wrappers run the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    import pi_sph_fluid_tpu_torch as T
    from pi_sph_fluid_tpu_torch.parallel import LocalComm, WindowDomain

    cfg = T.SPHConfig(r=(6.35 / 20_000) ** 0.5)
    fluid, braw = T.build_pool_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    g5 = np.tile(np.float32(G), (5, 1))
    out = {}
    for dev in ("cpu", "cuda"):
        dd = WindowDomain(cfg, b, bg, fluid.n, LocalComm(3), dev)
        before = _launches("density", "forces")
        state, st = dd.make_multi_step()(dd.init(fluid), g5)
        after = _launches("density", "forces")
        assert after == tuple(n + (15 if dev == "cuda" else 0) for n in before), (dev, after)
        assert int(st["overflow"].max()) == 0 and int(st["n_valid"][-1]) == fluid.n
        out[dev] = dd.gather(state)
    for f, tol in (("x", 1e-6), ("y", 1e-6), ("u", 1e-5), ("v", 1e-5)):
        torch.testing.assert_close(getattr(out["cuda"], f).cpu(), getattr(out["cpu"], f),
                                   rtol=0, atol=tol)


def _pool_domain(n: int, d: int, dev):
    import pi_sph_fluid_tpu_torch as T
    from pi_sph_fluid_tpu_torch.parallel import LocalComm, WindowDomain

    cfg = T.SPHConfig(r=(6.35 / n) ** 0.5)
    fluid, braw = T.build_pool_scene(cfg, "cpu")
    b, bg = T.prepare_boundary(braw, cfg)
    return WindowDomain(cfg, b, bg, fluid.n, LocalComm(d), dev), fluid


@pytest.mark.cuda
def test_sticky_group_launches_both_kernels_once_a_slab_a_tick():
    """A 3-slab WindowDomain of a 20k pool at resort_every=4 on the card:
    every tick, carried ones included, launches the density and the forces
    kernel once a slab; 8 ticks land within test_parallel_window.py's gates
    (1e-6 m, 1e-5 m/s) of the same domain on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    g8 = np.tile(np.float32(G), (8, 1))
    out = {}
    for dev in ("cpu", "cuda"):
        dd, fluid = _pool_domain(20_000, 3, dev)
        before = _launches("density", "forces")
        state, st = dd.make_multi_step(resort_every=4)(dd.init(fluid), g8)
        after = _launches("density", "forces")
        assert after == tuple(n + (24 if dev == "cuda" else 0) for n in before), (dev, after)
        assert int(st["overflow"].max()) == 0 and int(st["stale"].sum()) == 0
        assert int(st["n_valid"][-1]) == fluid.n
        out[dev] = dd.gather(state)
    for f, tol in (("x", 1e-6), ("y", 1e-6), ("u", 1e-5), ("v", 1e-5)):
        torch.testing.assert_close(getattr(out["cuda"], f).cpu(), getattr(out["cpu"], f),
                                   rtol=0, atol=tol)


@pytest.mark.cuda
def test_domain_render_launches_one_field_kernel_a_slab():
    """The per-slab renderer of a 3-slab 20k pool on the card launches the
    field kernel once a slab a frame, and its frame agrees with the same
    domain's frame on the CPU on at least 99.9% of the pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    import pi_sph_fluid_tpu_torch as T

    frames = {}
    for dev in ("cpu", "cuda"):
        dd, fluid = _pool_domain(20_000, 3, dev)
        render = dd.make_render(64, 128)
        before = _launches("field")[0]
        fb, ov = render(dd.init(fluid))
        torch.cuda.synchronize()
        assert _launches("field")[0] == before + (3 if dev == "cuda" else 0)
        assert int(ov) == 0
        frames[dev] = T.unpack_framebuffer(fb.cpu().numpy())
    assert (frames["cuda"] == frames["cpu"]).mean() >= 0.999


@pytest.mark.cuda
def test_dist_comm_stages_cuda_tensors_through_gloo(tmp_path):
    """Two processes on one card over gloo: DistComm's four methods on CUDA
    tensors equal LocalComm's (tests/test_torch_dd_multiprocess.py::
    check_dist_comm), every result back on the card, and each process
    counts the bytes it staged: per dtype 12 slab buffers (its one send and
    one receive of the two shifts, the sum and the max out and back, its
    two slabs out and the four back of the gather)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from test_torch_dd_multiprocess import check_dist_comm

    for res in check_dist_comm(tmp_path, "cuda"):
        assert int(res["staged"]) == 12 * (5 * 3 * 4 + 6 * 8)


@pytest.mark.cuda
def test_two_nccl_ranks_on_one_card_fail_loudly(tmp_path):
    """NCCL refuses a second rank on the card the first one holds: both
    processes exit non-zero with NCCL's error; nothing switches to gloo."""
    if not torch.cuda.is_available() or torch.cuda.device_count() != 1:
        pytest.skip("needs exactly one NVIDIA GPU")
    from test_torch_dd_multiprocess import comm_script

    outs = comm_script(tmp_path, "cuda", backend="nccl", ok=False)
    assert any("NCCL" in err or "nccl" in err for _, err in outs), outs[0][1][-4000:]


@pytest.mark.cuda
def test_tools_launch_the_kernels_on_the_card():
    """render_probe and dd_probe through their main() on the card at a
    small size launch the kernels for every tick and frame they run (no
    plain fallback): render_probe primes (one density and one forces
    launch), runs one group of 4 ticks and draws 2 x (2 + reps) frames;
    dd_probe runs one slab for one group and 8 ticks at each period."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from pi_sph_fluid_tpu_torch.tools import dd_probe, render_probe

    before = _launches("density", "forces", "field")
    out = render_probe.main(["--n", "20000", "--reps", "2"])
    after = _launches("density", "forces", "field")
    assert out["device"] == torch.cuda.get_device_name(0)
    assert out["reuse_overflow"] == 0 and out["self_overflow"] == 0
    assert tuple(a - b for a, b in zip(after, before)) == (5, 5, 8), (before, after)
    out = dd_probe.main(["--n", "20000", "--steps", "8"])
    ticks = sum(k + 8 for k in dd_probe.RESORTS)
    now = _launches("density", "forces")
    assert (now[0] - after[0], now[1] - after[1]) == (ticks, ticks)
    assert all(out[f"r{k}"]["n_valid"] == out["n"] for k in dd_probe.RESORTS)


@pytest.mark.cuda
def test_tracer_span_holds_its_launch_on_the_profiler_timeline():
    """A density launch inside a span of the port's tracer: on a CPU and
    CUDA profiler timeline its runtime launch call starts inside the span
    (the tracer's offset onto the profiler's clock holds on the card), and
    the kernel starts after the call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    eng, fluid = pool_engine(20_000, "cuda")
    pk, ctx, _ = eng._relayout(eng._initial_packed(fluid))
    args = (pk, eng._b_geo_d, ctx.spans, eng.cfg, eng.spec)
    wk.density_window(*args)       # the library's build and a first launch
    torch.cuda.synchronize()
    was_on = tracer.on
    tracer.enable()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with tracer.span("test.launch") as span:
                wk.density_window(*args)
            torch.cuda.synchronize()
    finally:
        if not was_on:
            tracer.disable()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    kernels = [e for e in events
               if e.device_type() == cuda and "density_window_kernel" in e.name()]
    assert len(kernels) == 1, [e.name() for e in events if e.device_type() == cuda]
    calls = [e for e in events if e.device_type() != cuda and e.name().startswith("cuda")
             and e.correlation_id() == kernels[0].correlation_id()]
    assert len(calls) == 1
    t = calls[0].start_ns()
    assert span.start_ns <= t < span.end_ns, (span, t, calls[0].name())
    assert kernels[0].start_ns() >= t
