// N-Queens neighborhood scores on Hopper (sm_90a).
//
// Replaces the TPU kernel `nqueens_neighborhood_scores` / `_kernel` in
// constraint_solver_tpu/ops/nqueens_pallas.py (def :122, pallas_call :159, body :50).
// For lane p, sampled column j (current row r_j) and every candidate row r':
//
//   score[p, j, r'] = cur[p] + 2 * ((rc[r'] - [r'==r_j]) + (dc[r'-c_j+n-1] - [r'==r_j])
//                                  + (ac[r'+c_j] - [r'==r_j]) - removed[p, j])
//
// and each row's minimum with its first (lowest) argmin.  Every value is a small
// integer held in float32, so the result is exact in any order and equals the
// plain PyTorch version bit for bit.
//
// What bounds it on this card: DRAM bytes.  At the solver's main shape (P=256
// lanes, A=50 columns, n=1000 rows) the call must write 51.2 MB of scores and read
// 5.3 MB of tables: 56.6 MB, 16.9 us at 3.35 TB/s.  It does ~10 float32 additions
// per score and no products, so the tensor cores play no part and the arithmetic
// (1.3e8 operations, ~2 us at 67 TFLOP/s) is far below the bytes.
//
// What the design does about it:
// - Grid (ceil(A/G), P): a block holds G warps, one sampled column of one lane
//   each (G = 8 at the main shape: 1,792 blocks).  The launch plan in
//   ops/nqueens_kernel.py halves G while the grid has fewer blocks than SMs.
// - Staged tables: the block copies its lane's rc [n], dc [2n-1] and ac [2n-1]
//   into dynamic shared memory once (20 KB at n = 1000) with 16-byte `cp.async`
//   copies, so each table byte crosses L2 -> SM once per G columns instead of
//   once per column, and the unaligned window starts (n-1-c, c) cost nothing.  A
//   table row need not start on 16 bytes (the rows of dc and ac are (2n-1)*4
//   bytes apart, and a view may have a storage offset): the copy starts at the
//   16-byte-aligned address at or below it and the table begins 0-3 floats into
//   its region.  Above 227 KB of tables (n > 11,617) the same source reads the
//   windows from global memory instead (template parameter kStaged).
// - Streaming stores: the scores are written once and never read back by this
//   kernel, so they go out with `__stcs` and do not evict the lanes' tables
//   from L2.  Where n % 4 == 0 (kVector), each lane of a warp takes 4 consecutive
//   rows of a 128-row strip and writes them as one 16-byte store; it reads each
//   window as two aligned 16-byte shared loads and a warp-uniform shift.
//   Otherwise each lane takes every 32nd row and stores 4 bytes, still coalesced.
// - The row minimum: each lane walks its rows in ascending order and keeps its
//   first minimum (strict <); a warp shuffle on (value, index) pairs, ties to the
//   lower index, finishes it.  No shared memory or block barrier is used in it.
// Not materialising the block, or fusing the column sample or the tabu first pick
// into this pass, changes the kernel's contract and is later work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kStrip = 4 * kWarp;  // rows one warp covers per step on the vector path

// Floats of shared memory a staged table of `len` floats takes: its 0-3 float
// head, the table, and room for the vector path's second 16-byte load, rounded
// to 16 bytes.  ops/nqueens_kernel.py `_staged_floats` is the same formula.
__host__ __device__ constexpr int staged_floats(int len) { return (len + 10) / 4 * 4; }

__host__ __device__ constexpr long long staged_bytes(int n) {
  return 4LL * (staged_floats(n) + 2LL * staged_floats(2 * n - 1));
}

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

// Issues 16-byte cp.async copies of table[0, len) into `dst`, starting at the
// 16-byte-aligned address at or below `table` (a float pointer is 4-byte
// aligned), and returns where table[0] lands in `dst` (0..3).  Every byte read
// lies in a 16-byte granule that holds a byte of the table.
__device__ __forceinline__ int stage(float* dst, const float* table, int len) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(table);
  const int head = static_cast<int>((addr & 15u) >> 2);
  const char* src = reinterpret_cast<const char*>(addr & ~static_cast<uintptr_t>(15));
  const uint32_t dst_s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int chunks = (head + len + 3) >> 2;
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst_s + 16u * k), "l"(src + 16LL * k)
                 : "memory");
  }
  return head;
}

// tab[w + i], from shared memory (staged) or global memory.
template <bool kStaged>
__device__ __forceinline__ float load1(const float* tab, int w, int i) {
  if constexpr (kStaged) {
    return tab[w + i];
  } else {
    return __ldg(tab + w + i);
  }
}

// tab[w + i .. w + i + 3] for i a multiple of 4.  Staged: two aligned 16-byte
// shared loads and a shift by w % 4, which is the same for the whole warp.
template <bool kStaged>
__device__ __forceinline__ float4 load4(const float* tab, int w, int i) {
  if constexpr (kStaged) {
    const int shift = w & 3;
    const float4* q = reinterpret_cast<const float4*>(tab + (w - shift) + i);
    const float4 lo = q[0];
    if (shift == 0) return lo;
    const float4 hi = q[1];
    if (shift == 1) return make_float4(lo.y, lo.z, lo.w, hi.x);
    if (shift == 2) return make_float4(lo.z, lo.w, hi.x, hi.y);
    return make_float4(lo.w, hi.x, hi.y, hi.z);
  } else {
    const float* q = tab + w + i;
    return make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
  }
}

struct Column {
  float base;  // cur[p]
  float rem;   // removed[p, j]
  int r;       // the column's current row
  __device__ __forceinline__ float score(float rc, float dc, float ac, int rp) const {
    const float same = rp == r ? 1.0f : 0.0f;
    const float added = (rc - same) + (dc - same) + (ac - same);
    return base + 2.0f * (added - rem);
  }
};

__device__ __forceinline__ void keep_first_min(float& best, int& best_i, float v, int i) {
  if (v < best) {  // rows come in ascending order, so strict < keeps the first
    best = v;
    best_i = i;
  }
}

template <bool kStaged, bool kVector>
__global__ void __launch_bounds__(kMaxWarps * kWarp) nqueens_scores_kernel(
    const float* __restrict__ rc, const float* __restrict__ dc, const float* __restrict__ ac,
    const int* __restrict__ cols, const int* __restrict__ rows,
    const float* __restrict__ removed, const float* __restrict__ cur,
    float* __restrict__ scores, float* __restrict__ row_min, int* __restrict__ row_arg,
    int a, int n) {
  extern __shared__ float4 smem[];
  const int p = blockIdx.y;
  const int table = 2 * n - 1;
  const float* rc_t = rc + static_cast<long long>(p) * n;
  const float* dc_t = dc + static_cast<long long>(p) * table;
  const float* ac_t = ac + static_cast<long long>(p) * table;
  int rc_w = 0, dc_w = 0, ac_w = 0;  // where element 0 of each table sits in rc_t, dc_t, ac_t
  if constexpr (kStaged) {
    float* s_rc = reinterpret_cast<float*>(smem);
    float* s_dc = s_rc + staged_floats(n);
    float* s_ac = s_dc + staged_floats(table);
    rc_w = stage(s_rc, rc_t, n);
    dc_w = stage(s_dc, dc_t, table);
    ac_w = stage(s_ac, ac_t, table);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    rc_t = s_rc;
    dc_t = s_dc;
    ac_t = s_ac;
  }

  const int lane = threadIdx.x & (kWarp - 1);
  const int j = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (j >= a) return;  // the last block's spare warps; no barrier follows
  const long long pj = static_cast<long long>(p) * a + j;
  const int c = cols[pj];
  const Column col{cur[p], removed[pj], rows[pj]};
  dc_w += n - 1 - c;  // the windows dc[r' - c + n - 1] and ac[r' + c]
  ac_w += c;
  float* out = scores + pj * n;

  float best = CUDART_INF_F;
  int best_i = INT_MAX;
  if constexpr (kVector) {
    for (int r0 = 4 * lane; r0 < n; r0 += kStrip) {
      const float4 x = load4<kStaged>(rc_t, rc_w, r0);
      const float4 y = load4<kStaged>(dc_t, dc_w, r0);
      const float4 z = load4<kStaged>(ac_t, ac_w, r0);
      const float4 v = make_float4(col.score(x.x, y.x, z.x, r0), col.score(x.y, y.y, z.y, r0 + 1),
                                   col.score(x.z, y.z, z.z, r0 + 2), col.score(x.w, y.w, z.w, r0 + 3));
      __stcs(reinterpret_cast<float4*>(out + r0), v);
      keep_first_min(best, best_i, v.x, r0);
      keep_first_min(best, best_i, v.y, r0 + 1);
      keep_first_min(best, best_i, v.z, r0 + 2);
      keep_first_min(best, best_i, v.w, r0 + 3);
    }
  } else {
    for (int rp = lane; rp < n; rp += kWarp) {
      const float v = col.score(load1<kStaged>(rc_t, rc_w, rp), load1<kStaged>(dc_t, dc_w, rp),
                                load1<kStaged>(ac_t, ac_w, rp), rp);
      __stcs(out + rp, v);
      keep_first_min(best, best_i, v, rp);
    }
  }
  warp_min(best, best_i);
  if (lane == 0) {
    row_min[pj] = best;
    row_arg[pj] = best_i;
  }
}

}  // namespace

// Launches on `stream` without synchronising and returns a cudaError_t (0 on
// success).  Shapes: rc [p, n], dc/ac [p, 2n-1], cols/rows/removed [p, a],
// cur [p]; scores [p, a, n], row_min/row_arg [p, a]; all contiguous, float
// pointers 4-byte aligned.  The plan (ops/nqueens_kernel.py `_launch_plan`):
// grid (grid_x, p) of blocks of 32 * cols_per_block threads, grid_x *
// cols_per_block >= a, p <= 65535; `staged` needs smem_bytes >= the staged
// tables' size; `vector` needs n % 4 == 0 and scores on 16 bytes.
extern "C" int nqueens_scores_launch(
    const void* rc, const void* dc, const void* ac, const void* cols, const void* rows,
    const void* removed, const void* cur, void* scores, void* row_min, void* row_arg,
    int p, int a, int n, int cols_per_block, int grid_x, int smem_bytes, int staged, int vector,
    void* stream) {
  if (cols_per_block < 1 || cols_per_block > kMaxWarps ||
      static_cast<long long>(grid_x) * cols_per_block < a ||
      (staged && smem_bytes < staged_bytes(n)) ||
      (vector && (n % 4 != 0 || reinterpret_cast<uintptr_t>(scores) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using Kernel = void (*)(const float*, const float*, const float*, const int*, const int*, const float*,
                          const float*, float*, float*, int*, int, int);
  const Kernel kernel = staged ? (vector ? nqueens_scores_kernel<true, true> : nqueens_scores_kernel<true, false>)
                               : (vector ? nqueens_scores_kernel<false, true> : nqueens_scores_kernel<false, false>);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(grid_x, p), kWarp * cols_per_block, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rc), static_cast<const float*>(dc), static_cast<const float*>(ac),
      static_cast<const int*>(cols), static_cast<const int*>(rows), static_cast<const float*>(removed),
      static_cast<const float*>(cur), static_cast<float*>(scores), static_cast<float*>(row_min),
      static_cast<int*>(row_arg), a, n);
  return static_cast<int>(cudaGetLastError());
}
