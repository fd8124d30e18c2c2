// The relayout of the window engine on Hopper (sm_90a): the cell keys and
// their histogram, the per-row and per-segment frame tables, the row move
// into the query layout and the per-block windows and span table, as four
// kernels that never wait for the host.
//
// Built by pi_sph_fluid_tpu_torch/ops/window/_build.py like window_kernels.cu
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared, no fast
// math) and bound through a plain C interface with ctypes.  Each entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError().
//
// This replaces no TPU kernel: the JAX package's relayout
// (pi_sph_fluid_tpu/models/engine_v3.py::_relayout, ops/pallas/triple.py) is
// jnp code that XLA fuses.  Its PyTorch transcription
// (ops/window/relayout.py::relayout_plain: a bincount CSR, a scatter-max and
// cummax row map, two row gathers and ~150 small operations) is bound on the
// card by launches and by four host synchronisations (the bincount's min and
// max, two boolean masks), and its cummax runs as one single-row scan over
// every layout slot.  Here the work is a few passes over the rows and the
// cells, each bound by bytes: the state's 32-byte rows are read twice (keys,
// row move) and written once, everything else is per cell or per block.  The
// outputs are the plain version's, bit for bit: every quantity is the same
// integer arithmetic, and the one float sum of the plain version (the window
// overflow) is an integer sum here, equal wherever that float sum is exact
// (below 2^24 lanes); above that both read as loss.
//
// Passes (ops/window/triple.py names the quantities):
//
// 1. relayout_keys: the key of every row (its cell id, n_cells for m <= 0,
//    in float32 exactly as ops/grid.py::cell_ids) and a histogram of
//    keys + 1 by integer atomics, aggregated per warp (a warp of layout
//    order rows holds few cells), into a zeroed workspace.  An integer count
//    does not depend on the order of the adds, so it is bincount's.  The
//    stable sort of the keys stays torch.argsort (cub's radix sort).
// 2. row_totals_kernel: one CUDA block a grid row sums its histogram
//    (row_count); the last block to finish scans the rows (rstart from the
//    rows' capacities rounded up to qb, and the sorted start of each row)
//    and the segments (seg_start from their strides), and writes T's
//    budget row.
// 3. frame_rows_kernel: one CUDA block a grid row scans its cells' fluid
//    counts (the row of the start grid) and its segment's cell counts (the
//    row of T: wlo, whi from the segment's column starts).
// 4. layout_blocks_kernel: one thread a layout slot finds its grid row by a
//    binary search of rstart (a table of n_rows + 1 ints, read through the
//    read-only cache), writes layout_src, moves the 32-byte row (or the inert row)
//    and computes the slot's cell; then each query block of qb slots reduces
//    its first and last cell and writes its window, its span table through
//    the start grids, and its overflow, summed in integers with one atomic a
//    CUDA block; the last CUDA block writes the overflow.
//
// The workspace (int32, see relayout_ws_ints): [overflow sum (u64) | two counters |
// histogram (n_cells + 2) | row_count (n_rows) | rstart (n_rows + 1) |
// sorted row start (n_rows) | seg_start (n_seg)]; relayout_keys zeroes
// everything up to the end of the histogram.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // CUDA block of every pass
constexpr int LANE = 128;           // segment strides round to this (triple.py)
constexpr int WS_HEAD = 4;          // overflow sum (2 ints) and two counters

struct Workspace {
  unsigned long long* acc;  // window lanes beyond cap, summed
  unsigned int* rows_done;  // row_totals_kernel blocks finished
  unsigned int* slots_done; // layout_blocks_kernel blocks finished
  int* hist;                // (n_cells + 2) counts of keys + 1
  int* row_count;           // (n_rows) live rows per grid row
  int* rstart;              // (n_rows + 1) layout slot of each grid row
  int* row_sorted;          // (n_rows) sorted slot of each grid row's first row
  int* seg_start;           // (n_seg) start of each candidate segment

  __host__ __device__ Workspace(void* base, int n_cells, int n_rows) {
    int* w = static_cast<int*>(base);
    acc = reinterpret_cast<unsigned long long*>(w);
    rows_done = reinterpret_cast<unsigned int*>(w + 2);
    slots_done = reinterpret_cast<unsigned int*>(w + 3);
    hist = w + WS_HEAD;
    row_count = hist + n_cells + 2;
    rstart = row_count + n_rows;
    row_sorted = rstart + n_rows + 1;
    seg_start = row_sorted + n_rows;
  }
};

// ops/grid.py::_floor_index: floor in float32, clamped into [0, n).  A NaN
// lands on -1 here and on 0 in torch; both clamp to 0.
__device__ __forceinline__ int floor_index(float a, float inv, int n) {
  const float f = fminf(fmaxf(floorf(__fmul_rn(a, inv)), -1.f), (float)n);
  return min(max((int)f, 0), n - 1);
}

// The key of a row: its row-major cell id, n_cells for a pad (m <= 0).
__device__ __forceinline__ int cell_key(float x, float y, float m, float inv,
                                        int n_rows, int n_cols) {
  return m > 0.f ? floor_index(y, inv, n_rows) * n_cols + floor_index(x, inv, n_cols)
                 : n_rows * n_cols;
}

__device__ __forceinline__ int2 add2(int2 a, int2 b) {
  return make_int2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ int2 warp_inclusive2(int2 v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, v.x, o);
    const int y = __shfl_up_sync(0xffffffffu, v.y, o);
    if (lane >= o) v = add2(v, make_int2(x, y));
  }
  return v;
}

// Exclusive prefix sums of a pair over a THREADS-thread block, and the
// block's totals; every thread must call it.  Ends in a barrier, so shared
// memory written before the call is visible after it.
__device__ int2 block_exclusive2(int2 v, int2* total) {
  __shared__ int2 s_warp[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int2 inc = warp_inclusive2(v);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < THREADS / 32 ? s_warp[lane] : make_int2(0, 0);
    w = warp_inclusive2(w);
    if (lane < THREADS / 32) s_warp[lane] = w;
  }
  __syncthreads();
  const int2 before = warp > 0 ? s_warp[warp - 1] : make_int2(0, 0);
  *total = s_warp[THREADS / 32 - 1];
  __syncthreads();
  return make_int2(before.x + inc.x - v.x, before.y + inc.y - v.y);
}

__device__ int block_sum(int v) {
  int2 total;
  block_exclusive2(make_int2(v, 0), &total);
  return total.x;
}

// The last CUDA block of a grid to pass here gets true; each block's writes
// before the call are visible to it.
__device__ bool last_block(unsigned int* done) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// ---------------------------------------------------------------------------
// 1. keys and their histogram
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
keys_kernel(const float* __restrict__ packed, int n, int* __restrict__ keys,
            int* __restrict__ hist, float inv, int n_rows, int n_cols) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  int key = -1;
  if (j < n) {
    const float* row = packed + 8 * (size_t)j;
    const float2 xy = *reinterpret_cast<const float2*>(row);
    key = cell_key(xy.x, xy.y, row[4], inv, n_rows, n_cols);
    keys[j] = key;
  }
  // one add a distinct key of the warp, of its count in the warp
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(hist + key + 1, __popc(peers));
}

// ---------------------------------------------------------------------------
// 2. row totals, then the row and segment scans in the last block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
row_totals_kernel(void* ws_base, const int* __restrict__ b_starts,
                  int* __restrict__ T, int n_rows, int n_cols, int qb,
                  int cap, int seg_q, int L) {
  const Workspace ws(ws_base, n_rows * n_cols, n_rows);
  const int r = blockIdx.x;
  int sum = 0;
  for (int c = threadIdx.x; c < n_cols; c += THREADS)
    sum += ws.hist[r * n_cols + c + 1];
  sum = block_sum(sum);
  if (threadIdx.x == 0) ws.row_count[r] = sum;
  if (!last_block(ws.rows_done)) return;

  // rstart: exclusive sums of the rows' capacities (counts rounded up to
  // qb); the sorted start of a row: exclusive sums of the counts
  int2 carry = make_int2(0, 0);
  for (int r0 = 0; r0 < n_rows; r0 += THREADS) {
    const int rr = r0 + threadIdx.x;
    const int cnt = rr < n_rows ? __ldcg(ws.row_count + rr) : 0;
    int2 total;
    const int2 ex = block_exclusive2(make_int2((cnt + qb - 1) / qb * qb, cnt), &total);
    if (rr < n_rows) {
      ws.rstart[rr] = carry.x + ex.x;
      ws.row_sorted[rr] = carry.y + ex.y;
    }
    carry = add2(carry, total);
  }
  if (threadIdx.x == 0) ws.rstart[n_rows] = carry.x;

  // segments: fluid and boundary rows of grid rows [s*seg_q - 1,
  // (s+1)*seg_q] (clamped), their stride rounded to LANE, and where each
  // starts; the whole length past L is T's budget excess
  const int n_seg = (n_rows + seg_q - 1) / seg_q;
  int seg_carry = 0;
  for (int s0 = 0; s0 < n_seg; s0 += THREADS) {
    const int s = s0 + threadIdx.x;
    int stride = 0;
    if (s < n_seg) {
      const int lo = max(s * seg_q - 1, 0), hi = min((s + 1) * seg_q, n_rows - 1);
      int len = 0;
      for (int rr = lo; rr <= hi; ++rr)
        len += __ldcg(ws.row_count + rr) + b_starts[(rr + 1) * n_cols] - b_starts[rr * n_cols];
      stride = (len + cap + 2 * LANE - 1) / LANE * LANE;
    }
    int2 total;
    const int2 ex = block_exclusive2(make_int2(stride, 0), &total);
    if (s < n_seg) ws.seg_start[s] = seg_carry + ex.x;
    seg_carry += total.x;
  }
  if (threadIdx.x == 0) {
    int4* t = reinterpret_cast<int4*>(T + 8 * (size_t)(n_rows * n_cols));
    t[0] = make_int4(0, 0, max(seg_carry - L, 0), 0);
    t[1] = make_int4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// 3. the start grid's and T's rows
// ---------------------------------------------------------------------------

// Fluid and boundary particles of column c over grid rows [lo, hi]: one
// entry of build_frame's segcnt; 0 outside the grid's columns.
__device__ __forceinline__ int seg_count(const int* hist, const int* b_starts,
                                         int c, int lo, int hi, int n_cols) {
  if (c < 0 || c >= n_cols) return 0;
  int n = 0;
  for (int rr = lo; rr <= hi; ++rr) {
    const int i = rr * n_cols + c;
    n += hist[i + 1] + b_starts[i + 1] - b_starts[i];
  }
  return n;
}

__global__ void __launch_bounds__(THREADS)
frame_rows_kernel(const void* ws_base, const int* __restrict__ b_starts,
                  int* __restrict__ f_grid, int* __restrict__ T, int n_rows,
                  int n_cols, int seg_q) {
  __shared__ int s_sc[THREADS + 2];  // segcnt of columns c0 - 1 .. c0 + THREADS
  const Workspace ws(const_cast<void*>(ws_base), n_rows * n_cols, n_rows);
  const int r = blockIdx.x, s = r / seg_q;
  const int lo = max(s * seg_q - 1, 0), hi = min((s + 1) * seg_q, n_rows - 1);
  const int f_base = ws.rstart[r], t_base = ws.seg_start[s];
  int2 carry = make_int2(0, 0);
  for (int c0 = 0; c0 <= n_cols; c0 += THREADS) {
    const int c = c0 + threadIdx.x;
    const int fc = c < n_cols ? ws.hist[r * n_cols + c + 1] : 0;
    const int sc = seg_count(ws.hist, b_starts, c, lo, hi, n_cols);
    s_sc[threadIdx.x + 1] = sc;
    if (threadIdx.x == 0) s_sc[0] = seg_count(ws.hist, b_starts, c0 - 1, lo, hi, n_cols);
    if (threadIdx.x == THREADS - 1)
      s_sc[THREADS + 1] = seg_count(ws.hist, b_starts, c0 + THREADS, lo, hi, n_cols);
    int2 total;
    const int2 ex = block_exclusive2(make_int2(fc, sc), &total);
    // start grid: layout row of cell (r, c), and of the row's end at c = m
    if (c <= n_cols) f_grid[r * (n_cols + 1) + c] = f_base + carry.x + ex.x;
    if (c < n_cols) {
      // T: [tcol_start of column c - 1, tcol_end of column c + 1], clamped
      const int tcs = t_base + carry.y + ex.y;
      const int wlo = c > 0 ? tcs - s_sc[threadIdx.x] : tcs;
      const int whi = c < n_cols - 1 ? tcs + sc + s_sc[threadIdx.x + 2] : tcs + sc;
      int4* t = reinterpret_cast<int4*>(T + 8 * (size_t)(r * n_cols + c));
      t[0] = make_int4(wlo, whi, 0, 0);
      t[1] = make_int4(0, 0, 0, 0);
    }
    carry = add2(carry, total);
    __syncthreads();  // s_sc is rewritten next round
  }
}

// ---------------------------------------------------------------------------
// 4. row move, windows and spans
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
layout_blocks_kernel(const float4* __restrict__ packed,
                     const long long* __restrict__ order,
                     const float4* __restrict__ inert, void* ws_base,
                     const int* __restrict__ T, const int* __restrict__ f_grid,
                     const int* __restrict__ b_grid, float4* __restrict__ out,
                     int* __restrict__ layout_src, int* __restrict__ w_start,
                     int* __restrict__ w_len, int2* __restrict__ spans,
                     int* __restrict__ overflow, int n_layout, int n_rows,
                     int n_cols, int qb, int cap, int seg_q, int ns, float inv) {
  __shared__ int s_cell[THREADS];
  __shared__ unsigned long long s_acc;
  const Workspace ws(ws_base, n_rows * n_cols, n_rows);
  const int n_cells = n_rows * n_cols;
  const int qpb = blockDim.x / qb;                 // query blocks a CUDA block
  const int lb = threadIdx.x / qb, l = threadIdx.x - lb * qb;
  const int b = blockIdx.x * qpb + lb;             // query block
  const int j = b * qb + l;                        // layout slot
  const bool active = lb < qpb && j < n_layout;
  if (threadIdx.x == 0) s_acc = 0ull;
  __syncthreads();

  int cell = n_cells;
  if (active) {
    // grid row: the last r with rstart[r] <= j (rstart[0] = 0)
    int lo = 0, hi = n_rows;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(ws.rstart + mid) <= j) lo = mid; else hi = mid;
    }
    const int k = j - __ldg(ws.rstart + lo);
    const int src = k < __ldg(ws.row_count + lo)
                        ? min(__ldg(ws.row_sorted + lo) + k, n_layout - 1)
                        : n_layout;
    layout_src[j] = src;
    float4 a, c;
    if (src < n_layout) {
      const size_t o = (size_t)order[src];
      a = packed[2 * o];
      c = packed[2 * o + 1];
    } else {
      a = inert[0];
      c = inert[1];
    }
    out[2 * (size_t)j] = a;
    out[2 * (size_t)j + 1] = c;
    cell = cell_key(a.x, a.y, c.x, inv, n_rows, n_cols);
  }
  s_cell[threadIdx.x] = cell;
  __syncthreads();

  if (active) {
    // the block's first cell and its last valid one (-1: no query)
    const int* qc = s_cell + lb * qb;
    int c_last = -1;
    for (int i = 0; i < qb; ++i)
      if (qc[i] < n_cells) c_last = max(c_last, qc[i]);
    const bool has_q = c_last >= 0;
    const int first = has_q ? qc[0] : n_cells;
    const int last = has_q ? c_last : n_cells;
    if (l == 0) {
      const int start = has_q ? T[8 * (size_t)first] : 0;
      const int len = has_q ? T[8 * (size_t)last + 1] - start : 0;
      w_start[b] = start;
      w_len[b] = len;
      if (len > cap) atomicAdd(&s_acc, (unsigned long long)(len - cap));
    }
    // spans (triple.py::span_index, block_spans): per segment row kk, the
    // start-grid entries of columns [c_lo, c_hi + 1) of the fluid grid (k <
    // cover) and of the boundary grid; entry n_cells is all 0
    const int cover = ns / 2;
    for (int k = l; k < ns; k += qb) {
      const int kk = k < cover ? k : k - cover;
      int i_lo = 0, i_hi = 0;
      bool ok = false;
      if (first < n_cells) {
        const int row = first / n_cols, col = first - row * n_cols;
        const int base = row / seg_q * seg_q;
        const int rr = max(base - 1, 0) + kk;
        ok = rr <= min(base + seg_q, n_rows - 1);
        i_lo = min(rr, n_rows - 1) * (n_cols + 1) + max(col - 1, 0);
      }
      if (last < n_cells) {
        const int row = last / n_cols, col = last - row * n_cols;
        const int base = row / seg_q * seg_q;
        const int rr = max(base - 1, 0) + kk;
        i_hi = min(rr, n_rows - 1) * (n_cols + 1) + min(col + 2, n_cols);
      }
      if (!ok) i_hi = i_lo;
      const int* g = k < cover ? f_grid : b_grid;
      const int s0 = g[i_lo];
      spans[(size_t)b * ns + k] = make_int2(s0, g[i_hi] - s0);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_acc) atomicAdd(ws.acc, s_acc);
  if (last_block(ws.slots_done) && threadIdx.x == 0) {
    // block_windows: the sum saturates at 1e8, the budget excess at 1000
    const unsigned long long sum = atomicAdd(ws.acc, 0ull);
    const int ov = (int)(sum < 100000000ull ? sum : 100000000ull);
    *overflow = ov + min(T[8 * (size_t)n_cells + 2], 1000) * 1000000;
  }
}

}  // namespace

extern "C" {

// int32 entries of the workspace (see the top of this file)
int relayout_ws_ints(int n_rows, int n_cols, int seg_q) {
  return WS_HEAD + n_rows * n_cols + 2 + 3 * n_rows + 1 + (n_rows + seg_q - 1) / seg_q;
}

int relayout_keys(const void* packed, void* keys, void* ws, int ws_ints, int n,
                  int n_rows, int n_cols, float inv, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int zeroed = WS_HEAD + n_rows * n_cols + 2;  // the head and the histogram
  if (n_rows < 1 || n_cols < 1 || ws_ints < zeroed) return (int)cudaErrorInvalidValue;
  const Workspace w(ws, n_rows * n_cols, n_rows);
  cudaError_t err = cudaMemsetAsync(ws, 0, (size_t)zeroed * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    keys_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        (const float*)packed, n, (int*)keys, w.hist, inv, n_rows, n_cols);
  }
  return (int)cudaGetLastError();
}

int relayout_frame(const void* packed, const void* order, const void* inert,
                   const void* b_starts, const void* b_grid, void* ws,
                   void* out, void* layout_src, void* f_grid, void* T,
                   void* w_start, void* w_len, void* spans, void* overflow,
                   int ws_ints, int n_layout, int n_rows, int n_cols, int qb, int cap,
                   int seg_q, int ns, int L, float inv, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_rows < 1 || n_cols < 1 || qb < 1 || qb > THREADS || seg_q < 1 ||
      ns < 0 || n_layout % qb != 0 || ws_ints < relayout_ws_ints(n_rows, n_cols, seg_q))
    return (int)cudaErrorInvalidValue;
  row_totals_kernel<<<n_rows, THREADS, 0, st>>>(ws, (const int*)b_starts, (int*)T,
                                                n_rows, n_cols, qb, cap, seg_q, L);
  frame_rows_kernel<<<n_rows, THREADS, 0, st>>>(ws, (const int*)b_starts, (int*)f_grid,
                                                (int*)T, n_rows, n_cols, seg_q);
  const int qpb = THREADS / qb;
  const int n_blocks = n_layout / qb;
  const int grid = n_blocks > 0 ? (n_blocks + qpb - 1) / qpb : 1;
  layout_blocks_kernel<<<grid, qpb * qb, 0, st>>>(
      (const float4*)packed, (const long long*)order, (const float4*)inert, ws,
      (const int*)T, (const int*)f_grid, (const int*)b_grid, (float4*)out,
      (int*)layout_src, (int*)w_start, (int*)w_len, (int2*)spans, (int*)overflow,
      n_layout, n_rows, n_cols, qb, cap, seg_q, ns, inv);
  return (int)cudaGetLastError();
}

}  // extern "C"
