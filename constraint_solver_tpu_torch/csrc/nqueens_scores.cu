// N-Queens neighborhood scores on Hopper (sm_90a).
//
// Replaces the TPU kernel `nqueens_neighborhood_scores` / `_kernel` in
// constraint_solver_tpu/ops/nqueens_pallas.py (pallas_call at :159, body :50-118).
// For lane p, sampled column j (current row r_j) and every candidate row r':
//
//   score[p, j, r'] = cur[p] + 2 * ((rc[r'] - [r'==r_j]) + (dc[r'-c_j+n-1] - [r'==r_j])
//                                  + (ac[r'+c_j] - [r'==r_j]) - removed[p, j])
//
// and each row's minimum with its first (lowest) argmin.  Every value is a small
// integer held in float32, so the result is exact and equals the TPU kernel's bit
// for bit.
//
// What bounds it on this card: the output.  At the solver's main shape
// (P=256 lanes, A=50 columns, n=1000 rows) one call writes P*A*n*4 B = 51.2 MB of
// scores and reads only the counter tables (~3 KB per lane, so they stay in L1/L2
// across the lane's A blocks); at 3.35 TB/s that is ~15 us of DRAM traffic.  Below
// that size the launch overhead dominates.
//
// What the design does about it: one launch covers all P lanes x A columns, grid
// (A, P) with one block per (lane, column) and 256 threads striding over the n
// rows.  The two diagonal windows dc[n-1-c_j : 2n-1-c_j] and ac[c_j : c_j+n] are
// plain contiguous loads, so every load and every store is coalesced; the TPU's
// lane rolls and its padding to 128 lanes have no counterpart here.  The row
// minimum is a warp-shuffle and shared-memory reduction over (value, index) pairs,
// ties to the lower index, so one path covers every n (the TPU kernel's int32
// (delta, lane) key packing and its two-pass fallback above n ~ 13k are gone).
// Not materialising the block, or fusing the Gumbel column sample or the tabu
// first pick into this pass, is later work.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void keep_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_min(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    keep_min(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kThreads) nqueens_scores_kernel(
    const float* __restrict__ rc, const float* __restrict__ dc, const float* __restrict__ ac,
    const int* __restrict__ cols, const int* __restrict__ rows,
    const float* __restrict__ removed, const float* __restrict__ cur,
    float* __restrict__ scores, float* __restrict__ row_min, int* __restrict__ row_arg,
    int a, int n) {
  const int j = blockIdx.x;
  const int p = blockIdx.y;
  const long long pj = static_cast<long long>(p) * a + j;
  const int c = cols[pj];
  const int r = rows[pj];
  const float rem = removed[pj];
  const float base = cur[p];
  const long long table = 2LL * n - 1;
  const float* rc_p = rc + static_cast<long long>(p) * n;
  const float* dc_w = dc + static_cast<long long>(p) * table + (n - 1 - c);
  const float* ac_w = ac + static_cast<long long>(p) * table + c;
  float* out = scores + pj * n;

  // Each thread walks its rows in ascending order, so a strict < keeps its
  // first minimum.
  float best = CUDART_INF_F;
  int best_i = INT_MAX;
  for (int rp = threadIdx.x; rp < n; rp += kThreads) {
    const float same = rp == r ? 1.0f : 0.0f;
    const float added = (rc_p[rp] - same) + (dc_w[rp] - same) + (ac_w[rp] - same);
    const float v = base + 2.0f * (added - rem);
    out[rp] = v;
    if (v < best) {
      best = v;
      best_i = rp;
    }
  }

  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_min(best, best_i);
  if (lane == 0) {
    warp_v[warp] = best;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? warp_v[lane] : CUDART_INF_F;
    best_i = lane < kWarps ? warp_i[lane] : INT_MAX;
    warp_min(best, best_i);
    if (lane == 0) {
      row_min[pj] = best;
      row_arg[pj] = best_i;
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising and returns cudaGetLastError().
// Shapes: rc [p, n], dc/ac [p, 2n-1], cols/rows/removed [p, a], cur [p];
// scores [p, a, n], row_min/row_arg [p, a].  All contiguous; p <= 65535.
extern "C" int nqueens_scores_launch(
    const void* rc, const void* dc, const void* ac, const void* cols, const void* rows,
    const void* removed, const void* cur, void* scores, void* row_min, void* row_arg,
    int p, int a, int n, void* stream) {
  const dim3 grid(a, p);
  nqueens_scores_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rc), static_cast<const float*>(dc),
      static_cast<const float*>(ac), static_cast<const int*>(cols),
      static_cast<const int*>(rows), static_cast<const float*>(removed),
      static_cast<const float*>(cur), static_cast<float*>(scores),
      static_cast<float*>(row_min), static_cast<int*>(row_arg), a, n);
  return static_cast<int>(cudaGetLastError());
}
