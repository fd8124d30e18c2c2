// Probe kernels for Hopper (sm_90a): the card's answers to the two questions
// the TPU probes in tools/ asked of the v5e's DMA engine.
//
// Built by pi_sph_fluid_tpu_torch/ops/window/_build.py into its own library
// (the window kernels' library does not rebuild when this file changes) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound through a plain C interface with ctypes.  Each entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError().
//
// Both kernels clamp a window start into [0, W - cap], as XLA's dynamic slice
// (and so the TPU kernels' interpret mode) clamps it; the probes' own starts
// never need the clamp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// max(a, 0) that propagates NaN like jnp.maximum.
__device__ __forceinline__ float max0(float a) { return a < 0.f ? 0.f : a; }

// Sum over an aligned group of G lanes of a warp; every lane of the warp calls.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int clamp_start(int s, int W, int cap) {
  return max(0, min(s, W - cap));
}

// Replaces _kernel via window_copy (tools/unaligned_probe.py:34-73).
//
// out[w, k, 0:cap] = src[k, s_w : s_w + cap] for every window w (one per
// (tile, block) pair, s_w = starts[w]) and every row k of the (K, L) source.
//
// Bound on this card: bytes (no arithmetic).  Each window reads K x cap x 4 B
// from device memory or L2 and writes as many; the bound counts each distinct
// source column once and each output once.  The TPU asked whether a DMA may
// start at an unaligned lane; here the question is what alignment lets the
// load path do.  One CUDA block per window, each thread moving 16-byte
// chunks: the output rows start at multiples of cap (a multiple of 4
// floats), so every store is one 16-byte vector store.  ALIGNED (starts that
// are multiples of 4 floats and L a multiple of 4, which the TPU's
// pl.multiple_of(a, 128) promised) loads each chunk with one 16-byte vector
// load; otherwise four 4-byte loads, correct at any offset.  An ALIGNED
// launch given an unaligned start takes the 4-byte path for that window, so
// a broken promise costs speed, never a misaligned-address fault.
template <bool ALIGNED>
__global__ void window_copy_kernel(const int* __restrict__ starts,
                                   const float* __restrict__ src,
                                   float4* __restrict__ out, int K, int L,
                                   int cap) {
  const int w = blockIdx.x;
  const int s = clamp_start(starts[w], L, cap);
  const int c4 = cap >> 2;  // 16-byte chunks per row
  float4* o = out + (size_t)w * K * c4;
  const bool vec = ALIGNED && ((s & 3) == 0) && ((L & 3) == 0);
  for (int e = threadIdx.x; e < K * c4; e += blockDim.x) {
    const int k = e / c4;
    const float* p = src + (size_t)k * L + s + 4 * (e - k * c4);
    if (vec) {
      o[e] = *reinterpret_cast<const float4*>(p);
    } else {
      o[e] = make_float4(p[0], p[1], p[2], p[3]);
    }
  }
}

// Replaces _kernel in run_variant (tools/span_dma_probe.py:38-126).
//
// For query i of block b of tile t, over the block's `spans` windows of
// span_cap source columns, w = w_s[t, b, s]:
//   out_i = sum_s sum_{c < span_cap} m_c max(1 - r, 0)^4 (1 + r),
//   r = |q_i,xy - (x_c, y_c)|,  (x, y, m) = rows 0-2 of the (8, W) source.
// The TPU kernel DMA'd all 8 rows of each span into VMEM and prefetched the
// next tile's spans; the math reads three rows, and the prefetch (tile t + 1's
// starts, `span_dma_probe.py:43-52`) is DMA bookkeeping that does not change
// the output, so neither is carried over: tile t reads w_s[t].
//
// Bound on this card: operations, 14 FP32 operations a pair lane (sqrt, max
// counted as one) against 12 B a distinct source column, shared by the
// block's qb queries.  What it waits for is the rate at which an SM starts
// instructions, so the design is the shipped window kernels' (see
// window_kernels.cu, "Threads"), spending fewer of them on a pair lane:
//  * a query gets a group of SPAN_G = 8 threads of a warp instead of a warp
//    (a 3-round shuffle instead of 5), one query block a CUDA block;
//  * a thread keeps SPAN_QPT = 2 queries in registers, so one shared load and
//    one turn of the loop feed two pair lanes;
//  * the columns are staged as one float4 (x, y, m, 0) a lane, one 16-byte
//    shared load instead of three 4-byte ones, through a fixed SPAN_CHUNK of
//    static shared memory (8 KB), so any spans x span_cap launches with no
//    opt-in;
//  * the square root is the card's approximation (one sqrt.approx.f32, at
//    most 2^-23 relative error by the PTX manual) instead of the correctly
//    rounded sqrtf, a sequence of about nine instructions: the probe's
//    tolerance (1e-5 of max |out| against the plain version) holds with it
//    (chip_smoke.py prints 1.7e-7 to 2.3e-7 of max |out| on an H100), and it
//    took a quarter off the kernel's time.  The shipped
//    density, forces and field kernels keep sqrtf: their outputs are held
//    against the C reference.
// All by measurement on an H100 80GB HBM3 at 700 W (G = 2..32, 1, 2 and 4
// query blocks a CUDA block, chunks of 128, 256 and 512 lanes, one and two
// queries a thread).  Staging reads each of the three source rows with
// coalesced loads, span by span: several spans cost one pass per span
// instead of one, and that difference is what the probe measures.
constexpr int SPAN_G = 8, SPAN_QPT = 2;
constexpr int SPAN_CHUNK = 512;

__device__ __forceinline__ float approx_sqrt(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int G, int QPT>
__global__ void span_density_kernel(const int* __restrict__ w_s,
                                    const float* __restrict__ q,
                                    const float* __restrict__ src,
                                    float* __restrict__ out, int qb, int spans,
                                    int span_cap, int W) {
  __shared__ float4 s_cand[SPAN_CHUNK];  // x, y, m, 0
  // one CUDA block per query block (t, b) = t*nqb + b: ceil(qb / QPT) groups
  // of G threads, each with up to QPT consecutive queries (the last group of
  // a qb that is no multiple of QPT has fewer: `has`); threads past the
  // groups (the block is rounded up to whole warps) take part in every
  // barrier and shuffle and touch no memory
  const int nt = (qb + QPT - 1) / QPT * G;
  const bool active = threadIdx.x < nt;
  const int g = threadIdx.x % G;
  const int u0 = threadIdx.x / G * QPT;  // first query of the group in its block
  const int i0 = blockIdx.x * qb + u0;
  bool has[QPT];
  float qx[QPT], qy[QPT], acc[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    qx[u] = qy[u] = acc[u] = 0.f;
    has[u] = active && u0 + u < qb;
    if (has[u]) {
      const float2 xy = *reinterpret_cast<const float2*>(q + 8 * (size_t)(i0 + u));
      qx[u] = xy.x;
      qy[u] = xy.y;
    }
  }
  const int* ws = w_s + (size_t)blockIdx.x * spans;
  const int n = spans * span_cap;
  for (int c0 = 0; c0 < n; c0 += SPAN_CHUNK) {
    const int c1 = min(n, c0 + SPAN_CHUNK);
    __syncthreads();  // the previous chunk is consumed
    if (active) {
      for (int sp = c0 / span_cap; sp * span_cap < c1; ++sp) {
        const int s0 = sp * span_cap;  // lane t of span sp is column col0 + t
        const int col0 = clamp_start(ws[sp], W, span_cap) - s0;
        const int hi = min(c1, s0 + span_cap);
        for (int t = max(c0, s0) + threadIdx.x; t < hi; t += nt) {
          const float* p = src + col0 + t;
          s_cand[t - c0] = make_float4(p[0], p[W], p[2 * (size_t)W], 0.f);
        }
      }
    }
    __syncthreads();
    const int m = active ? c1 - c0 : 0;
    for (int j = g; j < m; j += G) {
      const float4 c = s_cand[j];
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        const float dx = qx[u] - c.x;
        const float dy = qy[u] - c.y;
        const float r = approx_sqrt(dx * dx + dy * dy);
        const float t1 = max0(1.f - r);
        const float t1sq = t1 * t1;
        acc[u] += (c.z * (t1sq * t1sq)) * (1.f + r);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    acc[u] = group_sum<G>(acc[u]);
    if (has[u] && g == 0) out[i0 + u] = acc[u];
  }
}

}  // namespace

extern "C" {

int window_copy(const void* starts, const void* src, void* out, int n_windows,
                int K, int L, int cap, int aligned, void* stream) {
  if (n_windows > 0) {
    if (aligned) {
      window_copy_kernel<true><<<n_windows, 128, 0, (cudaStream_t)stream>>>(
          (const int*)starts, (const float*)src, (float4*)out, K, L, cap);
    } else {
      window_copy_kernel<false><<<n_windows, 128, 0, (cudaStream_t)stream>>>(
          (const int*)starts, (const float*)src, (float4*)out, K, L, cap);
    }
  }
  return (int)cudaGetLastError();
}

int span_density(const void* w_s, const void* q, const void* src, void* out,
                 int n_blocks, int qb, int spans, int span_cap, int W,
                 void* stream) {
  constexpr int G = SPAN_G, QPT = SPAN_QPT;
  const int threads = ((qb + QPT - 1) / QPT * G + 31) / 32 * 32;
  if (qb < 1 || threads > 1024 || spans < 1 || span_cap < 1)
    return (int)cudaErrorInvalidConfiguration;
  if (n_blocks > 0) {
    span_density_kernel<G, QPT><<<n_blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)w_s, (const float*)q, (const float*)src, (float*)out, qb,
        spans, span_cap, W);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
