// Per-query-block window kernels for Hopper (sm_90a): SPH density + Tait EOS,
// and SPH forces + the trailing half-kick.
//
// Built by pi_sph_fluid_tpu_torch/ops/window/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// (no --use_fast_math: it would change sqrtf and the divisions), and bound
// through a plain C interface with ctypes.  Each entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
//
// Layout (see ops/window/triple.py): the query layout is n_blocks blocks of qb
// consecutive rows of an (n_layout, 8) float32 array; block b's candidates are
// the contiguous rows [w_start[b], w_start[b] + w_len[b]) of a row-major
// candidate array, (L, 4) for density and (L, 8) for forces.  Lanes past
// w_len are not computed: in the TPU kernels they are real particles at least
// one whole cell (2H) away, or inert pads, so the support clamp
// max(1 - r/2H, 0) makes them contribute exactly 0 (or, where rounding leaves
// 1 - r/2H at one ulp above 0, a term below 1e-28 of the sum's scale).
//
// Threads: one CUDA block per query block (blockDim = 32 * qb), one warp per
// query.  The block stages its window (at most cap candidates) in shared
// memory once, every warp strides its lanes over it, and a __shfl_xor_sync
// butterfly reduces the warp's partial sums; lane 0 runs the per-query
// epilogue.  Pad queries (m = 0) produce 0/0 and inf lanes; their outputs are
// replaced by a conditional select, never multiplied by a mask.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// max(a, 0) / min(a, 0) that propagate NaN like jnp.maximum / jnp.minimum
// (fmaxf would drop it and hide a dead state from the stats scream).
__device__ __forceinline__ float max0(float a) { return a < 0.f ? 0.f : a; }
__device__ __forceinline__ float min0(float a) { return a > 0.f ? 0.f : a; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's window, clamped to the candidate array: [start, start + n).
__device__ __forceinline__ int window(const int* w_start, const int* w_len,
                                      int cap, int L, int* start) {
  int s = w_start[blockIdx.x];
  int len = min(w_len[blockIdx.x], cap);
  s = max(0, min(s, L));
  *start = s;
  return max(0, min(len, L - s));
}

// Replaces _density_kernel (pi_sph_fluid_tpu/ops/pallas/window_kernels.py:192).
//
// rho_i = norm * sum_j m_j (1 - r/2H)^4_+ (1 + 2r/H), self term included; then
// in the epilogue p = max(B((rho/rho0)^7 - 1), 0), cp = p/rho^2 (0 at rho = 0)
// and re = rho/2.  Writes geo8 = [x, y, u, v, m, cp, re, 0.5] (the fluid
// force-candidate rows) and rp = [rho, p].
//
// Bound on this card: the gathered candidate bytes (16 B a lane, read once per
// block from device memory or L2) and ~12 FP32 operations per pair lane.  The
// design reads each window once into shared memory for all qb queries of the
// block, so device-memory traffic is 16 B x window per block rather than per
// query, and the pair math runs from shared memory.
__global__ void density_window_kernel(
    const float4* __restrict__ q, const float4* __restrict__ geo,
    const int* __restrict__ w_start, const int* __restrict__ w_len,
    float4* __restrict__ geo8, float2* __restrict__ rp,
    int cap, int L, float norm, float half_inv_h, float two_inv_h,
    float inv_rho0, float tait_b) {
  extern __shared__ float4 s_cand[];
  int start;
  const int n = window(w_start, w_len, cap, L, &start);
  for (int t = threadIdx.x; t < n; t += blockDim.x) s_cand[t] = geo[start + t];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const float4 q0 = q[2 * i];
  float acc = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float4 c = s_cand[j];  // x, y, m~, 0
    const float dx = q0.x - c.x;
    const float dy = q0.y - c.y;
    const float r = sqrtf(dx * dx + dy * dy);
    const float t1 = max0(1.f - half_inv_h * r);
    const float t1sq = t1 * t1;
    acc += (c.z * (t1sq * t1sq)) * (1.f + two_inv_h * r);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const float4 q1 = q[2 * i + 1];
    const float rho = norm * acc;
    const float ratio = rho * inv_rho0;
    const float rr2 = ratio * ratio;
    const float rr4 = rr2 * rr2;
    const float p = max0(tait_b * (rr4 * rr2 * ratio - 1.f));
    const float cp = rho > 0.f ? p / (rho * rho) : 0.f;
    geo8[2 * i] = q0;
    geo8[2 * i + 1] = make_float4(q1.x, cp, 0.5f * rho, 0.5f);
    rp[i] = make_float2(rho, p);
  }
}

// Replaces _forces_kernel (pi_sph_fluid_tpu/ops/pallas/window_kernels.py:317).
//
// Over the window's [x, y, u, v, m~, cp, re, a] rows:
//   S = sum_j m~_j (cp_i + cp_j + k (W/W(0.2H))^4 + visc) (1 - r/2H)^3_+ d
//   visc = -alpha c H min(d.dv, 0) / ((r^2 + eps H^2)(a_j rho_i + re_j))
// then acc = g + (5 norm / H^2) S (0 on pad queries), and the finished state
// pk_next = [x, y, (u + half_dt au) damp, (v + half_dt av) damp, m, rho, p, id].
// half_dt = 0, damp = 1 leaves u and v bitwise unchanged (the priming pass).
//
// Bound on this card: the gathered candidate bytes (32 B a lane) and ~35 FP32
// operations, one sqrt and one division per pair lane.  As in the density
// kernel, the window is read once per block into shared memory and shared by
// the block's qb warps; the two viscosity divisions are fused into one.
__global__ void forces_window_kernel(
    const float4* __restrict__ q, const float4* __restrict__ geo8,
    const float2* __restrict__ rp, const float4* __restrict__ geo,
    const int* __restrict__ w_start, const int* __restrict__ w_len,
    float4* __restrict__ pk_next, float2* __restrict__ acc_out,
    int cap, int L, float gx, float gy, float half_dt, float damp,
    float half_inv_h, float two_inv_h, float eps_h2, float nach, float k_ap4,
    float gfac) {
  extern __shared__ float4 s_cand[];  // 2 float4 per candidate
  int start;
  const int n = window(w_start, w_len, cap, L, &start);
  for (int t = threadIdx.x; t < 2 * n; t += blockDim.x)
    s_cand[t] = geo[2 * start + t];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const float4 q0 = q[2 * i];      // x, y, u, v
  const float4 d1 = geo8[2 * i + 1];  // m, cp, re, a
  const float q_rho = 2.f * d1.z;  // re = rho/2 is an exact halving
  const float q_press = d1.y;
  float ax = 0.f, ay = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float4 c0 = s_cand[2 * j];      // x, y, u, v
    const float4 c1 = s_cand[2 * j + 1];  // m~, cp, re, a
    const float dx = q0.x - c0.x;
    const float dy = q0.y - c0.y;
    const float du = q0.z - c0.z;
    const float dv = q0.w - c0.w;
    const float r2 = dx * dx + dy * dy;
    const float r = sqrtf(r2);
    const float t1 = max0(1.f - half_inv_h * r);
    const float t1sq = t1 * t1;
    const float t13 = t1sq * t1;
    const float w_un = (t1sq * t1sq) * (1.f + two_inv_h * r);
    const float press = q_press + c1.y;
    const float w2 = w_un * w_un;
    const float artif = k_ap4 * (w2 * w2);
    const float xy_uv = dx * du + dy * dv;
    const float denom = c1.w * q_rho + c1.z;
    const float den = (r2 + eps_h2) * denom;
    const float visc = (nach * min0(xy_uv)) / den;
    const float coef = c1.x * (press + artif + visc) * t13;
    ax += coef * dx;
    ay += coef * dy;
  }
  ax = warp_sum(ax);
  ay = warp_sum(ay);
  if (lane == 0) {
    const float4 q1 = q[2 * i + 1];  // m, rho, p, id
    const float2 rho_p = rp[i];
    const bool real = q1.x > 0.f;
    const float au = real ? gx + gfac * ax : 0.f;
    const float av = real ? gy + gfac * ay : 0.f;
    acc_out[i] = make_float2(au, av);
    pk_next[2 * i] = make_float4(q0.x, q0.y, (q0.z + half_dt * au) * damp,
                                 (q0.w + half_dt * av) * damp);
    pk_next[2 * i + 1] = make_float4(q1.x, rho_p.x, rho_p.y, q1.w);
  }
}

}  // namespace

extern "C" {

int density_window(const void* q, const void* geo, const void* w_start,
                   const void* w_len, void* geo8, void* rp, int n_blocks,
                   int qb, int cap, int L, float norm, float half_inv_h,
                   float two_inv_h, float inv_rho0, float tait_b,
                   void* stream) {
  if (n_blocks > 0) {
    density_window_kernel<<<n_blocks, 32 * qb, cap * sizeof(float4),
                            (cudaStream_t)stream>>>(
        (const float4*)q, (const float4*)geo, (const int*)w_start,
        (const int*)w_len, (float4*)geo8, (float2*)rp, cap, L, norm,
        half_inv_h, two_inv_h, inv_rho0, tait_b);
  }
  return (int)cudaGetLastError();
}

int forces_window(const void* q, const void* geo8, const void* rp,
                  const void* geo, const void* w_start, const void* w_len,
                  void* pk_next, void* acc, int n_blocks, int qb, int cap,
                  int L, float gx, float gy, float half_dt, float damp,
                  float half_inv_h, float two_inv_h, float eps_h2, float nach,
                  float k_ap4, float gfac, void* stream) {
  if (n_blocks > 0) {
    forces_window_kernel<<<n_blocks, 32 * qb, 2 * cap * sizeof(float4),
                           (cudaStream_t)stream>>>(
        (const float4*)q, (const float4*)geo8, (const float2*)rp,
        (const float4*)geo, (const int*)w_start, (const int*)w_len,
        (float4*)pk_next, (float2*)acc, cap, L, gx, gy, half_dt, damp,
        half_inv_h, two_inv_h, eps_h2, nach, k_ap4, gfac);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
