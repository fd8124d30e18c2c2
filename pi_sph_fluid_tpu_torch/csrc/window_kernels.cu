// Per-query-block window kernels for Hopper (sm_90a): SPH density + Tait EOS,
// SPH forces + the trailing half-kick, and the metaball field of the display
// pixels (queries are pixel centers, candidates the fluid).
//
// Built by pi_sph_fluid_tpu_torch/ops/window/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (no --use_fast_math: it would change sqrtf and the divisions), and bound
// through a plain C interface with ctypes.  Each entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
//
// Layout (see ops/window/triple.py): the query layout is n_blocks blocks of qb
// consecutive rows of an (n_layout, 8) float32 array.
//
// Density and forces read a block's candidates through its span table
// (block_spans): ns [start, len] pairs, the first ns/2 naming contiguous runs
// of layout-order fluid rows, the other ns/2 contiguous runs of the static
// boundary rows.  Laid end to end in span order they are the lanes of the
// block's window; the kernels compute the first min(sum len, cap) of them.
// No candidate array is gathered beforehand: the density kernel reads fluid
// candidates from the packed state itself and the forces kernel from the
// density kernel's geo8 output, so the rows are the current tick's even when
// the spans are an earlier relayout's (a sticky layout).  Every span is
// clamped into its array, so no table can make a kernel read outside it.
// Lanes inside a window but outside a query's 3x3 stencil are real particles
// at least one whole cell (2H) away, so the support clamp max(1 - r/2H, 0)
// makes them contribute exactly 0 (or, where rounding leaves 1 - r/2H at one
// ulp above 0, a term below 1e-28 of the sum's scale): no per-lane masks.
//
// Threads (density, forces): the pair math of a window is a few thousand
// short dependent chains, and what bounds it on this card is latency and
// the rate at which an SM starts operations, not bytes.  So a query gets a
// group of G threads of one warp (G = 2 for density, 4 for forces: 16 or 8
// queries a warp), each thread strides the staged lanes by G, and log2(G)
// rounds of __shfl_xor_sync reduce the group; a CUDA block is NQB = 2 query blocks (qb * G threads each), 64
// or 128 threads at qb = 16, small enough that many blocks are resident per
// SM and the loads of one overlap the math of the others.  The lanes are
// staged in shared memory CHUNK at a time (4 KB a query block for
// density, 8 KB for forces, whatever the cap), read span by span with
// coalesced loads; the groups of a warp read the same staged lanes, which
// shared memory serves as one broadcast.  Each thread loads its query row
// before the staging, so that latency is hidden behind it.
//
// Lanes out of reach: the forces kernel spends ~80 machine operations on a
// lane, and about five lanes in six lie outside the query's support (85% of
// the query-lane pairs of the 100k pool), where the lane's term is exactly 0.
// A thread therefore first tests all its lanes of a staged chunk with the
// cheap part alone (dx, dy, r^2 against reach2()), FORCES_U at once, into a
// bit mask of the lanes in reach, and then does the full arithmetic,
// unchanged, only on those.  Each lane's test and each lane's full term is
// one dependent chain (a shared load, then the sqrt and the division), which
// the SM's warps cannot hide when a thread has one lane in flight; so the
// tests run as FORCES_U independent chains and the lanes in reach two at a
// time, two chains in flight, their terms still added in lane order: the
// sums are bitwise those of one lane at a time.  Walking a mask, the threads
// of a warp meet at every pair.  A non-finite r^2 counts as in reach, so a
// dead position still poisons the sums it always poisoned.  This is the one
// place where the kernel departs from the TPU kernel and from the plain
// version, which compute NaN * 0 on such a lane: a far lane's non-finite cp,
// re or velocity does not reach the queries it is out of reach of (its own
// row is non-finite, which the stats scream counts).  The density kernel's full lane
// is ~20 machine operations and the same split made it slower (measured on
// an H100), so it computes every lane.
//
// The field kernel reads the fluid half of a pixel block's spans from the
// packed state too (boundary lanes add nothing to the field), and resolves
// them itself: a block's static index pairs into the relayout's per-cell
// start grid give each span's start and end, so a frame prepares nothing.
// Same mapping with its own constants: a pixel block is qb = 8 queries and a
// 64x128 raster has only 1,024 of them for 132 SMs, so a pixel gets a larger
// group (16 threads, one pixel block of 128 threads a CUDA block) and the
// staged chunk is 512 lanes: the fastest of G = 4..32, NQB = 1..4 and chunks
// of 256 and 512 at 64x128 on the 100k and the 1M pool; at 256x128 (4,096
// pixel blocks) G = 4 or 8 is a tenth faster at 100k and no faster at 1M.
//
// Pad queries (m = 0) produce 0/0 and inf lanes; their outputs are replaced by
// a conditional select, never multiplied by a mask.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Thread mapping of the three kernels (see "Threads" above), set by
// measurement on an H100 80GB HBM3 at 700 W; no caller's parameter.
constexpr int DENSITY_G = 2, DENSITY_NQB = 2;
constexpr int FORCES_G = 4, FORCES_NQB = 2;
constexpr int FORCES_U = 8;       // lanes a forces thread tests for reach at once
constexpr int FIELD_G = 16, FIELD_NQB = 1;
constexpr int FIELD_CHUNK = 512;  // lanes the field kernel stages at once

namespace {

// max(a, 0) / min(a, 0) that propagate NaN like jnp.maximum / jnp.minimum
// (fmaxf would drop it and hide a dead state from the stats scream).
__device__ __forceinline__ float max0(float a) { return a < 0.f ? 0.f : a; }
__device__ __forceinline__ float min0(float a) { return a > 0.f ? 0.f : a; }

// Sum over an aligned group of G lanes of a warp; every lane of the warp calls.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// r^2 past which a lane's support clamp max(1 - r/2H, 0) is exactly 0: the
// square of 2H = 1 / half_inv_h, widened by 1e-4 so that every lane the
// rounding of sqrt and of the clamp could leave above 0 stays inside.
__device__ __forceinline__ float reach2(float half_inv_h) {
  const float two_h = 1.f / half_inv_h;
  return two_h * two_h * 1.0001f;
}

constexpr int MAX_SPANS = 16;  // window_kernels.py checks n_spans against it
constexpr int CHUNK = 256;     // lanes staged at once per query block

// A query block's span table in shared memory, each span clamped into its
// array (fluid rows [0, n_fluid), boundary rows [0, n_bnd)).
struct SpanTable {
  int start[MAX_SPANS];
  int len[MAX_SPANS];
};

// Threads tl, tl + nt, ... of the query block fill its table; the caller
// synchronises before anyone reads it.
__device__ __forceinline__ void load_spans(const int2* __restrict__ spans_b,
                                           int ns, int n_fluid, int n_bnd,
                                           int tl, int nt, SpanTable& t) {
  for (int k = tl; k < ns; k += nt) {
    const int2 s = spans_b[k];
    const int n_src = 2 * k < ns ? n_fluid : n_bnd;
    const int st = max(0, min(s.x, n_src));
    t.start[k] = st;
    t.len[k] = max(0, min(s.y, n_src - st));
  }
}

// The same for a pixel block, whose spans are all fluid and are given as
// index pairs [i_lo, i_hi] into the start grid: span k is source rows
// [grid[i_lo], grid[i_hi]).  The indices are clamped into the grid and the
// span into the source, so neither a table nor a grid of garbage reads
// outside an array.
__device__ __forceinline__ void load_grid_spans(
    const int2* __restrict__ idx_b, int ns, const int* __restrict__ grid,
    int n_grid, int n_src, int tl, int nt, SpanTable& t) {
  for (int k = tl; k < ns; k += nt) {
    const int2 ix = idx_b[k];
    const int s = grid[max(0, min(ix.x, n_grid - 1))];
    const long long len = (long long)grid[max(0, min(ix.y, n_grid - 1))] - s;
    const int st = max(0, min(s, n_src));
    t.start[k] = st;
    t.len[k] = (int)max(0LL, min(len, (long long)(n_src - st)));
  }
}

// Lanes the query block computes: min(sum len, cap).
__device__ __forceinline__ int span_lanes(const SpanTable& t, int ns, int cap) {
  int n = 0;
  for (int k = 0; k < ns; ++k) n += t.len[k];
  return min(n, cap);
}

// Where a thread sits: CUDA block -> NQB query blocks of qb queries -> G
// threads a query.  Threads past the last query block of the grid, or past
// NQB * qb * G in a block rounded up to whole warps, are not `active`: they
// take part in every barrier and shuffle and touch no memory.
template <int G, int NQB>
struct Place {
  int lb, tl, nt, b, i, g;
  bool active;
  __device__ __forceinline__ Place(int n_blocks, int qb) {
    nt = qb * G;
    lb = threadIdx.x / nt;
    tl = threadIdx.x - lb * nt;
    b = blockIdx.x * NQB + lb;
    active = lb < NQB && b < n_blocks;
    if (!active) lb = 0;
    i = b * qb + tl / G;
    g = tl % G;
  }
};

// Replaces _density_kernel (pi_sph_fluid_tpu/ops/pallas/window_kernels.py:192).
//
// rho_i = norm * sum_j m_j (1 - r/2H)^4_+ (1 + 2r/H), self term included; then
// in the epilogue p = max(B((rho/rho0)^7 - 1), 0), cp = p/rho^2 (0 at rho = 0)
// and re = rho/2.  Writes geo8 = [x, y, u, v, m, cp, re, 0.5] (the fluid
// force-candidate rows) and rp = [rho, p].  Fluid candidates are x, y and m of
// the packed rows q = [x, y, u, v | m, rho, p, id] (one 32-byte sector a row,
// of which 12 bytes are loaded), boundary candidates the rows [x, y, psi, 0].
//
// Bound on this card: operations.  16 FP32 operations a pair lane over
// qb x window lanes against 32 B (fluid) or 16 B (boundary) a distinct
// candidate row, shared by the block's qb queries; at the 100k pool 3.3 us by
// operations against 2-3 us by bytes (chip_smoke.py reckons both from each
// run's spans).  What the kernel actually waits for is the latency of the
// span -> candidate -> query chain of loads and the start of ~20 machine
// operations a lane; see "Threads" above for what the design does about it.
template <int G, int NQB>
__global__ void density_window_kernel(
    const float4* __restrict__ q, const float4* __restrict__ bgeo,
    const int2* __restrict__ spans, float4* __restrict__ geo8,
    float2* __restrict__ rp, int n_blocks, int qb, int cap, int ns,
    int n_fluid, int n_bnd, float norm, float half_inv_h, float two_inv_h,
    float inv_rho0, float tait_b) {
  __shared__ float4 s_cand[NQB][CHUNK];  // x, y, m~, 0
  __shared__ SpanTable s_tab[NQB];
  const Place<G, NQB> at(n_blocks, qb);
  float4 q0 = make_float4(0.f, 0.f, 0.f, 0.f), q1 = q0;
  if (at.active) {
    q0 = q[2 * at.i];
    q1 = q[2 * at.i + 1];
    load_spans(spans + (size_t)at.b * ns, ns, n_fluid, n_bnd, at.tl, at.nt,
               s_tab[at.lb]);
  }
  __syncthreads();
  const SpanTable& tab = s_tab[at.lb];
  float4* cand = s_cand[at.lb];
  const int n = at.active ? span_lanes(tab, ns, cap) : 0;
  float acc = 0.f;
  // the barrier at the loop's head also says the previous chunk is consumed
  for (int c0 = 0; __syncthreads_or(c0 < n); c0 += CHUNK) {
    const int c1 = min(n, c0 + CHUNK);
    int p = 0;  // lanes before span k
    for (int k = 0; k < ns && p < c1; ++k) {
      const int len = tab.len[k];
      const int hi = min(p + len, c1);
      const int row0 = tab.start[k] - p;  // lane t is source row row0 + t
      if (2 * k < ns) {
        for (int t = max(p, c0) + at.tl; t < hi; t += at.nt) {
          const float4* r = q + 2 * (size_t)(row0 + t);
          const float2 xy = *reinterpret_cast<const float2*>(r);
          const float m = *reinterpret_cast<const float*>(r + 1);
          cand[t - c0] = make_float4(xy.x, xy.y, m, 0.f);
        }
      } else {
        for (int t = max(p, c0) + at.tl; t < hi; t += at.nt)
          cand[t - c0] = bgeo[row0 + t];
      }
      p += len;
    }
    __syncthreads();
    const int m = c1 - c0;  // <= 0 once this query block is done
    for (int j = at.g; j < m; j += G) {
      const float4 c = cand[j];
      const float dx = q0.x - c.x;
      const float dy = q0.y - c.y;
      const float r = sqrtf(dx * dx + dy * dy);
      const float t1 = max0(1.f - half_inv_h * r);
      const float t1sq = t1 * t1;
      acc += (c.z * (t1sq * t1sq)) * (1.f + two_inv_h * r);
    }
  }
  acc = group_sum<G>(acc);
  if (at.active && at.g == 0) {
    const float rho = norm * acc;
    const float ratio = rho * inv_rho0;
    const float rr2 = ratio * ratio;
    const float rr4 = rr2 * rr2;
    const float p = max0(tait_b * (rr4 * rr2 * ratio - 1.f));
    const float cp = rho > 0.f ? p / (rho * rho) : 0.f;
    geo8[2 * at.i] = q0;
    geo8[2 * at.i + 1] = make_float4(q1.x, cp, 0.5f * rho, 0.5f);
    rp[at.i] = make_float2(rho, p);
  }
}

// Replaces _forces_kernel (pi_sph_fluid_tpu/ops/pallas/window_kernels.py:317).
//
// Over the candidates' [x, y, u, v, m~, cp, re, a] rows (fluid: the rows of
// geo8; boundary: [x, y, 0, 0, psi, 0, 0, 1]):
//   S = sum_j m~_j (cp_i + cp_j + k (W/W(0.2H))^4 + visc) (1 - r/2H)^3_+ d
//   visc = -alpha c H min(d.dv, 0) / ((r^2 + eps H^2)(a_j rho_i + re_j))
// then acc = g + (5 norm / H^2) S (0 on pad queries), and the finished state
// pk_next = [x, y, (u + half_dt au) damp, (v + half_dt av) damp, m, rho, p, id].
// half_dt = 0, damp = 1 leaves u and v bitwise unchanged (the priming pass).
//
// Bound on this card: 39 FP32 operations (one sqrt and one division among
// them) on a pair lane in reach and 6 (dx, dy, r^2 and the compare) on a lane
// out of reach, whose term is 0, against 32 B a distinct candidate row;
// chip_smoke.py counts the lanes in reach of each run's inputs and takes the
// larger of the two times.  As in the density kernel the wait is for load
// latency and the SM's operation rate; the same thread mapping, with the
// staged rows split into two planes ([x, y, u, v] and [m~, cp, re, a]) so that
// a group's two 16-byte reads a lane are each contiguous, the full arithmetic
// only on lanes in reach, several lanes in flight a thread (see "Lanes out of
// reach" above), and the two viscosity divisions fused into one.
template <int G, int NQB>
__global__ void forces_window_kernel(
    const float4* __restrict__ q, const float4* __restrict__ geo8,
    const float2* __restrict__ rp, const float4* __restrict__ bgeo,
    const int2* __restrict__ spans, float4* __restrict__ pk_next,
    float2* __restrict__ acc_out, int n_blocks, int qb, int cap, int ns,
    int n_fluid, int n_bnd, float gx, float gy, float half_dt, float damp,
    float half_inv_h, float two_inv_h, float eps_h2, float nach, float k_ap4,
    float gfac) {
  __shared__ float4 s_cand[NQB][2][CHUNK];  // planes: x, y, u, v | m~, cp, re, a
  __shared__ SpanTable s_tab[NQB];
  const Place<G, NQB> at(n_blocks, qb);
  float4 q0 = make_float4(0.f, 0.f, 0.f, 0.f), d1 = q0, q1 = q0;
  float2 rho_p = make_float2(0.f, 0.f);
  if (at.active) {
    q0 = q[2 * at.i];         // x, y, u, v
    d1 = geo8[2 * at.i + 1];  // m, cp, re, a
    if (at.g == 0) {
      q1 = q[2 * at.i + 1];   // m, rho, p, id
      rho_p = rp[at.i];
    }
    load_spans(spans + (size_t)at.b * ns, ns, n_fluid, n_bnd, at.tl, at.nt,
               s_tab[at.lb]);
  }
  __syncthreads();
  const SpanTable& tab = s_tab[at.lb];
  float4* cand_a = s_cand[at.lb][0];
  float4* cand_b = s_cand[at.lb][1];
  const int n = at.active ? span_lanes(tab, ns, cap) : 0;
  const float q_rho = 2.f * d1.z;  // re = rho/2 is an exact halving
  const float q_press = d1.y;
  const float cut2 = reach2(half_inv_h);
  float ax = 0.f, ay = 0.f;
  static_assert(CHUNK / G <= 64 && (CHUNK / G) % FORCES_U == 0,
                "a thread's lanes of a chunk are the bits of one 64-bit mask");
  for (int c0 = 0; __syncthreads_or(c0 < n); c0 += CHUNK) {
    const int c1 = min(n, c0 + CHUNK);
    int p = 0;
    for (int k = 0; k < ns && p < c1; ++k) {
      const int len = tab.len[k];
      const int hi = min(p + len, c1);
      // half-row t of the chunk is float4 2 * (row0 + lane) + half of src
      const float4* src =
          (2 * k < ns ? geo8 : bgeo) + 2 * (ptrdiff_t)(tab.start[k] - p);
      for (int t = 2 * max(p, c0) + at.tl; t < 2 * hi; t += at.nt) {
        const float4 v = src[t];
        ((t & 1) ? cand_b : cand_a)[(t >> 1) - c0] = v;
      }
      p += len;
    }
    __syncthreads();
    const int m = c1 - c0;
    // The thread's lanes of the chunk are j = g + k G, k < CHUNK / G; bit k
    // of `mask` says lane j is in reach.  FORCES_U lanes are tested at once,
    // as independent chains.
    unsigned long long mask = 0ull;
    for (int k0 = 0; at.g + k0 * G < m; k0 += FORCES_U) {
      unsigned bits = 0u;
#pragma unroll
      for (int u = 0; u < FORCES_U; ++u) {
        const int j = at.g + (k0 + u) * G;
        if (j < m) {
          const float2 xy = *reinterpret_cast<const float2*>(cand_a + j);
          const float dx = q0.x - xy.x;
          const float dy = q0.y - xy.y;
          if (!(dx * dx + dy * dy >= cut2)) bits |= 1u << u;
        }
      }
      mask |= (unsigned long long)bits << k0;
    }
    // The full arithmetic of lane j in reach: its coefficient, and dx, dy.
    auto term = [&](int j, float& dx, float& dy) {
      const float4 c0v = cand_a[j];  // x, y, u, v
      const float4 c1v = cand_b[j];  // m~, cp, re, a
      dx = q0.x - c0v.x;
      dy = q0.y - c0v.y;
      const float r2 = dx * dx + dy * dy;
      const float du = q0.z - c0v.z;
      const float dv = q0.w - c0v.w;
      const float r = sqrtf(r2);
      const float t1 = max0(1.f - half_inv_h * r);
      const float t1sq = t1 * t1;
      const float t13 = t1sq * t1;
      const float w_un = (t1sq * t1sq) * (1.f + two_inv_h * r);
      const float press = q_press + c1v.y;
      const float w2 = w_un * w_un;
      const float artif = k_ap4 * (w2 * w2);
      const float xy_uv = dx * du + dy * dv;
      const float denom = c1v.w * q_rho + c1v.z;
      const float den = (r2 + eps_h2) * denom;
      const float visc = (nach * min0(xy_uv)) / den;
      return c1v.x * (press + artif + visc) * t13;
    };
    // Two lanes in reach at a time, both chains in flight, their terms added
    // in lane order; a thread's last odd lane is computed twice, added once.
    while (mask) {
      const int ka = __ffsll(mask) - 1;
      mask &= mask - 1;
      const bool two = mask != 0ull;
      const int kb = two ? __ffsll(mask) - 1 : ka;
      mask &= mask - 1;
      float dxa, dya, dxb, dyb;
      const float ca = term(at.g + ka * G, dxa, dya);
      const float cb = term(at.g + kb * G, dxb, dyb);
      ax += ca * dxa;
      ay += ca * dya;
      if (two) {
        ax += cb * dxb;
        ay += cb * dyb;
      }
    }
  }
  ax = group_sum<G>(ax);
  ay = group_sum<G>(ay);
  if (at.active && at.g == 0) {
    const bool real = q1.x > 0.f;
    const float au = real ? gx + gfac * ax : 0.f;
    const float av = real ? gy + gfac * ay : 0.f;
    acc_out[at.i] = make_float2(au, av);
    pk_next[2 * at.i] = make_float4(q0.x, q0.y, (q0.z + half_dt * au) * damp,
                                    (q0.w + half_dt * av) * damp);
    pk_next[2 * at.i + 1] = make_float4(q1.x, rho_p.x, rho_p.y, q1.w);
  }
}

// Replaces _field_kernel (pi_sph_fluid_tpu/render/metaballs_window.py:164).
//
// Per pixel, the unweighted metaball sum over the fluid rows [x, y, u, v | m,
// ...] of its block's spans:
//   out_i = sum_j [m_j > 0] (1 - r/2H)^4_+ (1 + 2r/H)
// over the first min(sum len, cap) lanes in span order.  The caller scales by
// norm / W(px/2) and thresholds at 1.  The validity gate is a select, taken
// once as a lane is staged: a NaN mass adds 0, a NaN position propagates
// (0 * NaN), as jnp.where does in the TPU kernel.
//
// Bound on this card: 17 FP32 operations a pair lane over qb x fluid lanes
// against the bytes the function needs (x, y and m, 12 B, of a distinct fluid
// row, though the card moves the row's 32-byte sector; 12 B a pixel, the
// index pairs and the start grid); chip_smoke.py reckons both from each
// run's spans.  What the kernel waits for is the chain index
// pair -> start grid -> rows -> pixel and, at 64x128, too few pixel blocks to
// fill the card; see FIELD_G above.  The pixel cap grows with the particle
// count (512 lanes on the drop, 3584 at 4M), so the window streams through
// one FIELD_CHUNK of shared memory: every cap launches with the same 8 KB a
// pixel block and no opt-in.
template <int G, int NQB>
__global__ void field_window_kernel(
    const float4* __restrict__ q, const float4* __restrict__ rows,
    const int* __restrict__ grid, const int2* __restrict__ span_idx,
    float* __restrict__ out, int n_blocks, int qb, int cap, int ns, int n_src,
    int n_grid, float half_inv_h, float two_inv_h) {
  __shared__ float4 s_cand[NQB][FIELD_CHUNK];  // x, y, [m > 0], 0
  __shared__ SpanTable s_tab[NQB];
  const Place<G, NQB> at(n_blocks, qb);
  float2 q0 = make_float2(0.f, 0.f);
  if (at.active) {
    q0 = *reinterpret_cast<const float2*>(q + 2 * at.i);  // x, y
    load_grid_spans(span_idx + (size_t)at.b * ns, ns, grid, n_grid, n_src,
                    at.tl, at.nt, s_tab[at.lb]);
  }
  __syncthreads();
  const SpanTable& tab = s_tab[at.lb];
  float4* cand = s_cand[at.lb];
  const int n = at.active ? span_lanes(tab, ns, cap) : 0;
  float acc = 0.f;
  for (int c0 = 0; __syncthreads_or(c0 < n); c0 += FIELD_CHUNK) {
    const int c1 = min(n, c0 + FIELD_CHUNK);
    int p = 0;
    for (int k = 0; k < ns && p < c1; ++k) {
      const int len = tab.len[k];
      const int hi = min(p + len, c1);
      const int row0 = tab.start[k] - p;
      for (int t = max(p, c0) + at.tl; t < hi; t += at.nt) {
        const float4* r = rows + 2 * (size_t)(row0 + t);
        const float2 xy = *reinterpret_cast<const float2*>(r);
        const float m = *reinterpret_cast<const float*>(r + 1);
        cand[t - c0] = make_float4(xy.x, xy.y, m > 0.f ? 1.f : 0.f, 0.f);
      }
      p += len;
    }
    __syncthreads();
    const int m = c1 - c0;
    for (int j = at.g; j < m; j += G) {
      const float4 c = cand[j];
      const float dx = q0.x - c.x;
      const float dy = q0.y - c.y;
      const float r = sqrtf(dx * dx + dy * dy);
      const float t1 = max0(1.f - half_inv_h * r);
      const float t1sq = t1 * t1;
      acc += (c.z * (t1sq * t1sq)) * (1.f + two_inv_h * r);
    }
  }
  acc = group_sum<G>(acc);
  if (at.active && at.g == 0) out[at.i] = acc;
}

}  // namespace

extern "C" {

// Threads of a CUDA block of NQB query blocks of qb queries, G threads a
// query, rounded up to whole warps; 0 if that is no launchable block.
static int span_threads(int qb, int g, int nqb, int ns) {
  const int t = (nqb * qb * g + 31) / 32 * 32;
  return (qb < 1 || ns < 0 || ns > MAX_SPANS || t > 1024) ? 0 : t;
}

int density_window(const void* q, const void* bgeo, const void* spans,
                   void* geo8, void* rp, int n_blocks, int qb, int cap, int ns,
                   int n_fluid, int n_bnd, float norm, float half_inv_h,
                   float two_inv_h, float inv_rho0, float tait_b,
                   void* stream) {
  constexpr int G = DENSITY_G, NQB = DENSITY_NQB;
  const int threads = span_threads(qb, G, NQB, ns);
  if (threads == 0) return (int)cudaErrorInvalidConfiguration;
  if (n_blocks > 0) {
    density_window_kernel<G, NQB><<<(n_blocks + NQB - 1) / NQB, threads, 0,
                                    (cudaStream_t)stream>>>(
        (const float4*)q, (const float4*)bgeo, (const int2*)spans,
        (float4*)geo8, (float2*)rp, n_blocks, qb, cap, ns, n_fluid, n_bnd,
        norm, half_inv_h, two_inv_h, inv_rho0, tait_b);
  }
  return (int)cudaGetLastError();
}

int forces_window(const void* q, const void* geo8, const void* rp,
                  const void* bgeo, const void* spans, void* pk_next,
                  void* acc, int n_blocks, int qb, int cap, int ns,
                  int n_fluid, int n_bnd, float gx, float gy, float half_dt,
                  float damp, float half_inv_h, float two_inv_h, float eps_h2,
                  float nach, float k_ap4, float gfac, void* stream) {
  constexpr int G = FORCES_G, NQB = FORCES_NQB;
  const int threads = span_threads(qb, G, NQB, ns);
  if (threads == 0) return (int)cudaErrorInvalidConfiguration;
  if (n_blocks > 0) {
    forces_window_kernel<G, NQB><<<(n_blocks + NQB - 1) / NQB, threads, 0,
                                   (cudaStream_t)stream>>>(
        (const float4*)q, (const float4*)geo8, (const float2*)rp,
        (const float4*)bgeo, (const int2*)spans, (float4*)pk_next,
        (float2*)acc, n_blocks, qb, cap, ns, n_fluid, n_bnd, gx, gy, half_dt,
        damp, half_inv_h, two_inv_h, eps_h2, nach, k_ap4, gfac);
  }
  return (int)cudaGetLastError();
}

int field_window(const void* q, const void* rows, const void* grid,
                 const void* span_idx, void* out, int n_blocks, int qb,
                 int cap, int ns, int n_src, int n_grid, float half_inv_h,
                 float two_inv_h, void* stream) {
  constexpr int G = FIELD_G, NQB = FIELD_NQB;
  const int threads = span_threads(qb, G, NQB, ns);
  if (threads == 0 || n_grid < 1) return (int)cudaErrorInvalidConfiguration;
  if (n_blocks > 0) {
    field_window_kernel<G, NQB><<<(n_blocks + NQB - 1) / NQB, threads, 0,
                                  (cudaStream_t)stream>>>(
        (const float4*)q, (const float4*)rows, (const int*)grid,
        (const int2*)span_idx, (float*)out, n_blocks, qb, cap, ns, n_src,
        n_grid, half_inv_h, two_inv_h);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
