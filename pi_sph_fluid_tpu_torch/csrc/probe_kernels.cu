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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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
// block's qb queries.  As in the density kernel, one CUDA block per query
// block stages its spans x span_cap columns of rows 0-2 in shared memory
// (struct of arrays, 12 B a lane: 6 KB at the probe's 512 lanes), one warp
// per query strides the staged lanes, and a __shfl_xor_sync butterfly
// reduces the warp's partial sums.  Several spans cost one staging pass per
// span instead of one: that difference is what the probe measures.
__global__ void span_density_kernel(const int* __restrict__ w_s,
                                    const float* __restrict__ q,
                                    const float* __restrict__ src,
                                    float* __restrict__ out, int spans,
                                    int span_cap, int W) {
  extern __shared__ float s_lane[];  // [x | y | m], spans * span_cap each
  const int n = spans * span_cap;
  float* sx = s_lane;
  float* sy = s_lane + n;
  float* sm = s_lane + 2 * n;
  const int* ws = w_s + (size_t)blockIdx.x * spans;  // block (t, b) = t*nqb + b
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int sp = j / span_cap;
    const int c = clamp_start(ws[sp], W, span_cap) + (j - sp * span_cap);
    sx[j] = src[c];
    sy[j] = src[(size_t)W + c];
    sm[j] = src[2 * (size_t)W + c];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const float qx = q[8 * (size_t)i];
  const float qy = q[8 * (size_t)i + 1];
  float acc = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float dx = qx - sx[j];
    const float dy = qy - sy[j];
    const float r = sqrtf(dx * dx + dy * dy);
    const float t1 = max0(1.f - r);
    const float t1sq = t1 * t1;
    acc += (sm[j] * (t1sq * t1sq)) * (1.f + r);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[i] = acc;
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
  if (n_blocks > 0) {
    span_density_kernel<<<n_blocks, 32 * qb,
                          3 * spans * span_cap * sizeof(float),
                          (cudaStream_t)stream>>>(
        (const int*)w_s, (const float*)q, (const float*)src, (float*)out, spans,
        span_cap, W);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
