// QAP's swap row minimum on Hopper (sm_90a): K1, `qap_swap_row_min`.
//
// Replaces no Pallas kernel.  It stands for the fused pass that XLA makes of
// the JAX package's compact and incremental QAP neighborhoods
// (constraint_solver_tpu/models/qap.py:202-224 `neighborhood_compact` and
// :325-341 `neighborhood_inc`): the swap deltas and their masked row-wise
// min + argmin in one pass over the delta block.  For lane k and facilities a, b:
//
//   w[k, a, b] = cur[k] + 2 * ((((H[a,b] + H[b,a]) - H[a,a]) - H[b,b]) + (2 * F[a,b]) * G[a,b])   (b > a)
//   w[k, a, b] = +inf                                                                              (b <= a)
//
// and each row's minimum with its first argmin over b, as torch.min takes them:
// a NaN wins (the first NaN), then the smaller value, ties to the smaller b; a
// row with no finite entry (row n-1 always) gives (inf, 0).  Every operation is
// one float32 rounding in the order above, written with __fadd_rn / __fsub_rn /
// __fmul_rn so that nvcc contracts nothing into an FMA: the result equals the
// plain PyTorch version (ops/qap_row_min.py) bit for bit for any float input.
//
// What bounds it on this card: DRAM bytes.  A row a needs H[a, b] and H[b, a]
// for every b > a, so the pass reads the whole of H, and the strict upper
// triangles of G and F: at (P, n) = (4, 4096) 268.4 + 134.2 + 33.5 MB plus
// 0.2 MB of outputs, 0.130 ms at 3.35 TB/s.  It does 9 float32 operations per
// swap (3.0e8 there, 4.5 us at 67 TFLOP/s), far below the bytes.  To stream at
// that rate the card needs some 3.3 MB of reads in flight at all times (3.35
// TB/s times about 1 us of loaded latency), about 25 KB on each of the 132 SMs.
//
// The design, in two paths; ops/qap_row_min.py `_launch_plan` picks one and
// passes its grid, block, stages and shared memory to `qap_row_min_launch`.
//
// The ring path (n % 4 == 0 and tables on 16 bytes):
// - Work items: a (lane, strip pair).  Strip s holds the kT = 32 rows from 32 s
//   and walks b from its own first row to n in tiles of kCols = 64 columns, so
//   it has ceil((n - 32 s) / 64) tiles; strips x and ceil(n/32) - 1 - x go
//   together, so every item walks about n / 64 + 1 tiles.  Items are numbered
//   lane-fastest: the P lanes of one pair run side by side, and their reads of
//   the shared F tiles after the first come from L2.
// - A persistent grid of at most two 256-thread blocks per SM (102.6 KB of
//   shared memory each) walks the items: block i takes items i, i + grid, ....
//   At the three shapes the solvers give K1, (4, 4096), (16, 1024) and (64,
//   256), there are 256 items of equal length for 264 block slots, so the
//   busiest SM has 2 items against a mean of 1.94.
// - A ring of kStages = 3 stages in dynamic shared memory.  A stage holds one
//   tile: H[a, b], G[a, b] and F[a, b] as 32 x 64 rows, the transposed term
//   H[b, a] as 64 rows of the strip's 32 columns padded to 36 floats, H[b, b],
//   H[a, a] and cur[k]: 34,192 bytes, all of it filled by `cp.async`, 16 bytes
//   a copy for the tables and 4 for the scalars.  While stage t is scored, the
//   copies of stages t + 1 and t + 2 are in flight: 64 KB a block, 128 KB an SM.
//   One __syncthreads a tile; the block's walk crosses items without draining.
//   cp.async and not TMA: the tile's ragged edges at n and the skipped lower
//   triangle are per-chunk predicates; the padded layout is free; nothing is
//   encoded on the host per call (a capture bakes in only the pointers); and
//   the copies come from all 256 threads, 8 each a tile, with no producer warp
//   to balance against the scoring.
// - Scoring: warp w owns the strip's rows 4w .. 4w + 3, lane x the columns x
//   and x + 32 of each tile.  The direct terms are read along a row (32
//   consecutive floats a warp); the transposed term H[b, 4w .. 4w + 3] is one
//   float4, and with rows of 36 floats the 8 lanes of each quarter-warp hit 8
//   distinct 4-bank groups: no bank conflicts.  Each lane keeps (value,
//   index) per row while it walks b upward; at the end of a strip a warp
//   shuffle on the pairs, ties to the smaller index, finishes each of its four
//   rows.  No cross-warp or cross-block merge.
// - The launch needs 102,576 bytes of dynamic shared memory, above the 48 KB a
//   launch gets unasked: `qap_row_min_init` sets the attribute (and the
//   shared-memory carveout, for two blocks an SM) once per device, before any
//   capture, so a CUDA graph can capture the launch itself.
//
// The ragged path (any other n, or a table off 16 bytes): the strip loop, a block
// of 8 warps per (strip pair, lane), H[b-tile, a-strip] staged in shared memory
// padded by one float, the direct terms read into registers.  A row stride of
// n floats with n % 4 != 0 is not 16-byte aligned, so neither `cp.async` of 16
// bytes nor a TMA tensor map can take it.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kT = 32;       // rows of a strip
constexpr int kWarps = 8;    // warps of a block
constexpr int kMaxLanes = 65535;  // the ragged grid's y dimension

// The ring path's tiles and stages (ops/qap_row_min.py mirrors these).
constexpr int kCols = 64;                  // columns of a tile
constexpr int kThreads = kWarp * kWarps;   // 256
constexpr int kStages = 3;
constexpr int kHtStride = kT + 4;          // a transposed row: 32 floats and 4 of padding
constexpr int kHd = 0;                     // H[a0 + r, b0 + c] at kHd + r * kCols + c
constexpr int kGd = kHd + kT * kCols;      // G, likewise
constexpr int kFd = kGd + kT * kCols;      // F, likewise
constexpr int kHt = kFd + kT * kCols;      // H[b0 + c, a0 + r] at kHt + c * kHtStride + r
constexpr int kHdb = kHt + kCols * kHtStride;  // H[b0 + c, b0 + c]
constexpr int kHaa = kHdb + kCols;         // H[a0 + r, a0 + r]
constexpr int kCur = kHaa + kT;            // cur[k], and 3 floats to keep 16 bytes
constexpr int kStageFloats = kCur + 4;     // 8,548
constexpr int kStageBytes = 4 * kStageFloats;  // 34,192
constexpr int kRingBytes = kStages * kStageBytes;  // 102,576
static_assert(kHt % 4 == 0 && kHdb % 4 == 0 && kHaa % 4 == 0 && kStageFloats % 4 == 0, "16-byte rows");
static_assert(kCols == 2 * kWarp && kT == 4 * kWarps, "lane x: columns x, x + 32; warp w: rows 4w .. 4w + 3");

// torch.min's order on (value, index) pairs: NaN first (the smaller index
// among NaNs), then the smaller value, equal values to the smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  if (isnan(v)) return !isnan(bv) || i < bi;
  if (isnan(bv)) return false;
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ float swap_score(float c, float hab, float hba, float haa, float hbb, float f, float g) {
  float s = __fadd_rn(hab, hba);
  s = __fsub_rn(s, haa);
  s = __fsub_rn(s, hbb);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(2.0f, f), g));
  return __fadd_rn(c, __fmul_rn(2.0f, s));
}

// The warp's best (value, index) of a row into lane 0, ties to the smaller index.
__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// ---- The ragged path: the strip loop, loads straight into registers ----

constexpr int kRows = kT / kWarps;  // rows of a strip per warp

__global__ void __launch_bounds__(kWarp * kWarps) qap_row_min_kernel(
    const float* __restrict__ h, const float* __restrict__ g, const float* __restrict__ flow,
    const float* __restrict__ cur, long long cur_stride, float* __restrict__ rmin,
    long long* __restrict__ rarg, int n) {
  __shared__ float ht[kT][kT + 1];  // ht[r][c] = H[b0 + r, a0 + c]
  __shared__ float hdb[kT];         // H[b0 + c, b0 + c]
  const int k = blockIdx.y;
  const int x = threadIdx.x;
  const int w = threadIdx.y;
  const long long nn = static_cast<long long>(n) * n;
  const float* hk = h + k * nn;
  const float* gk = g + k * nn;
  const float c = cur[k * cur_stride];
  const int strips = (n + kT - 1) / kT;

  for (int pass = 0; pass < 2; ++pass) {
    const int s = pass == 0 ? static_cast<int>(blockIdx.x) : strips - 1 - static_cast<int>(blockIdx.x);
    if (pass == 1 && s <= static_cast<int>(blockIdx.x)) break;  // an odd count's middle strip runs once
    const int a0 = s * kT;
    float haa[kRows], best[kRows];
    int best_i[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int a = a0 + w + kWarps * j;
      haa[j] = a < n ? hk[static_cast<long long>(a) * (n + 1)] : 0.0f;
      best[j] = CUDART_INF_F;
      best_i[j] = 0;
    }
    for (int b0 = a0; b0 < n; b0 += kT) {
      const int b = b0 + x;
      float hab[kRows], f[kRows], gv[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int a = a0 + w + kWarps * j;
        if (a < b && b < n) {
          const long long ab = static_cast<long long>(a) * n + b;
          hab[j] = hk[ab];
          f[j] = flow[ab];
          gv[j] = gk[ab];
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = w + kWarps * j;
        const int bt = b0 + r, at = a0 + x;
        ht[r][x] = (bt < n && at < n) ? hk[static_cast<long long>(bt) * n + at] : 0.0f;
      }
      if (w == 0) hdb[x] = b < n ? hk[static_cast<long long>(b) * (n + 1)] : 0.0f;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int a = a0 + w + kWarps * j;
        if (a < b && b < n) {
          const float v = swap_score(c, hab[j], ht[x][w + kWarps * j], haa[j], hdb[x], f[j], gv[j]);
          if (better(v, b, best[j], best_i[j])) {
            best[j] = v;
            best_i[j] = b;
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      float v = best[j];
      int i = best_i[j];
      warp_best(v, i);
      const int a = a0 + w + kWarps * j;
      if (x == 0 && a < n) {
        const long long ka = static_cast<long long>(k) * n + a;
        rmin[ka] = v;
        rarg[ka] = i;
      }
    }
  }
}

// ---- The ring path: tiles through a ring of stages filled by cp.async ----

__device__ __forceinline__ unsigned shared_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Until at most kStages - 2 groups of this thread's copies are pending: the
// oldest stage has landed.
__device__ __forceinline__ void wait_oldest_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// A block's place in its walk: item (lane-fastest (lane, strip pair) index),
// which strip of the pair, which tile of the strip.
struct Walk {
  int item;
  int seg;
  int tile;
};

struct Tile {
  int k;   // lane
  int a0;  // the strip's first row
  int b0;  // the tile's first column
};

// The tile at `at`; false once the block's items are done.
__device__ __forceinline__ bool locate(const Walk& at, int p, int strips, int items, Tile& t) {
  if (at.item >= items) return false;
  const int x = at.item / p;
  t.k = at.item - x * p;
  t.a0 = (at.seg == 0 ? x : strips - 1 - x) * kT;
  t.b0 = t.a0 + at.tile * kCols;
  return true;
}

// The next tile after `t` (at `at`); `end_of_strip` says that `t` was its strip's last.
__device__ __forceinline__ void advance(Walk& at, const Tile& t, int p, int n, int strips, bool& end_of_strip) {
  end_of_strip = t.b0 + kCols >= n;
  if (!end_of_strip) {
    ++at.tile;
    return;
  }
  at.tile = 0;
  const int x = at.item / p;
  if (at.seg == 0 && strips - 1 - x > x) {  // an odd count's middle strip runs once
    at.seg = 1;
    return;
  }
  at.seg = 0;
  at.item += gridDim.x;
}

// This thread's copies of tile t into stage sp: 8 of 16 bytes (two chunks of
// each direct table and two of the transposed one) and at most one of 4.
__device__ __forceinline__ void load_tile(float* sp, const Tile& t, const float* __restrict__ h,
                                          const float* __restrict__ g, const float* __restrict__ flow,
                                          const float* __restrict__ cur, long long cur_stride, int n, int tid) {
  const long long nn = static_cast<long long>(n) * n;
  const float* hk = h + t.k * nn;
  const float* gk = g + t.k * nn;
  constexpr int kChunks = kT * kCols / 4;  // 16-byte chunks of one table's tile: 512
  static_assert(kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {  // direct: 32 rows of 16 chunks
    const int q = tid + i * kThreads;
    const int r = q / (kCols / 4), c = 4 * (q % (kCols / 4));
    const int a = t.a0 + r, b = t.b0 + c;
    if (a < n && b < n && b + 3 > a) {  // a chunk wholly at or below the diagonal is never scored
      const long long ab = static_cast<long long>(a) * n + b;
      copy16(sp + kHd + r * kCols + c, hk + ab);
      copy16(sp + kGd + r * kCols + c, gk + ab);
      copy16(sp + kFd + r * kCols + c, flow + ab);
    }
  }
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {  // transposed: 64 rows of 8 chunks
    const int q = tid + i * kThreads;
    const int c = q / (kT / 4), r = 4 * (q % (kT / 4));
    const int b = t.b0 + c, a = t.a0 + r;
    if (b < n && a < b) copy16(sp + kHt + c * kHtStride + r, hk + static_cast<long long>(b) * n + a);
  }
  if (tid < kCols) {
    const int b = t.b0 + tid;
    if (b < n) copy4(sp + kHdb + tid, hk + static_cast<long long>(b) * (n + 1));
  } else if (tid < kCols + kT) {
    const int a = t.a0 + tid - kCols;
    if (a < n) copy4(sp + kHaa + tid - kCols, hk + static_cast<long long>(a) * (n + 1));
  } else if (tid == kCols + kT) {
    copy4(sp + kCur, cur + t.k * cur_stride);
  }
}

__global__ void __launch_bounds__(kThreads, 2) qap_row_min_ring_kernel(
    const float* __restrict__ h, const float* __restrict__ g, const float* __restrict__ flow,
    const float* __restrict__ cur, long long cur_stride, float* __restrict__ rmin,
    long long* __restrict__ rarg, int p, int n) {
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x;
  const int w = tid / kWarp, x = tid % kWarp;
  const int strips = (n + kT - 1) / kT;
  const int items = p * ((strips + 1) / 2);

  Walk load_at{static_cast<int>(blockIdx.x), 0, 0};
  Walk use_at = load_at;
  bool unused;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    Tile t;
    if (locate(load_at, p, strips, items, t)) {
      load_tile(ring + s * kStageFloats, t, h, g, flow, cur, cur_stride, n, tid);
      advance(load_at, t, p, n, strips, unused);
    }
    commit_copies();  // empty past the end: the group count stays one a stage
  }

  float best[4];
  int best_i[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    best[j] = CUDART_INF_F;
    best_i[j] = 0;
  }
  int stage = 0;
  Tile t;
  while (locate(use_at, p, strips, items, t)) {
    wait_oldest_stage();
    __syncthreads();  // the stage is whole for every thread; the one read last step is free
    {
      Tile lt;
      if (locate(load_at, p, strips, items, lt)) {
        const int ls = stage == 0 ? kStages - 1 : stage - 1;
        load_tile(ring + ls * kStageFloats, lt, h, g, flow, cur, cur_stride, n, tid);
        advance(load_at, lt, p, n, strips, unused);
      }
      commit_copies();
    }
    const float* sp = ring + stage * kStageFloats;
    const float c = sp[kCur];
    const float4 aa = *reinterpret_cast<const float4*>(sp + kHaa + 4 * w);
    const float haa[4] = {aa.x, aa.y, aa.z, aa.w};
#pragma unroll
    for (int half = 0; half < kCols / kWarp; ++half) {
      const int cb = x + kWarp * half;
      const int b = t.b0 + cb;
      const float4 tr = *reinterpret_cast<const float4*>(sp + kHt + cb * kHtStride + 4 * w);
      const float hba[4] = {tr.x, tr.y, tr.z, tr.w};
      const float hbb = sp[kHdb + cb];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * w + j;
        const int a = t.a0 + r;
        if (a < b && b < n) {
          const int o = r * kCols + cb;
          const float v = swap_score(c, sp[kHd + o], hba[j], haa[j], hbb, sp[kFd + o], sp[kGd + o]);
          if (better(v, b, best[j], best_i[j])) {
            best[j] = v;
            best_i[j] = b;
          }
        }
      }
    }
    bool end_of_strip;
    advance(use_at, t, p, n, strips, end_of_strip);
    if (end_of_strip) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        warp_best(best[j], best_i[j]);
        const int a = t.a0 + 4 * w + j;
        if (x == 0 && a < n) {
          const long long ka = static_cast<long long>(t.k) * n + a;
          rmin[ka] = best[j];
          rarg[ka] = best_i[j];
        }
        best[j] = CUDART_INF_F;
        best_i[j] = 0;
      }
    }
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // nothing in flight at exit (the last groups are empty)
}

}  // namespace

// Sets the ring path's shared-memory attributes on the current device: the
// ring's 102,576 bytes of dynamic shared memory, and the carveout that leaves
// room for two blocks an SM.  Call once per device, outside any stream capture.
// Returns a cudaError_t (0 on success).
extern "C" int qap_row_min_init() {
  cudaError_t err = cudaFuncSetAttribute(qap_row_min_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kRingBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(qap_row_min_ring_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
  }
  return static_cast<int>(err);
}

// Launches on `stream` without synchronising and returns a cudaError_t (0 on
// success).  Shapes: h, g [p, n, n] and flow [n, n], contiguous; cur [p] with
// element stride cur_stride; rmin float [p, n], rarg int64 [p, n]; p >= 1, n
// >= 1, n * n * p addressable in 64 bits.  The plan (ops/qap_row_min.py
// `_launch_plan`) must be one this file builds: ring = 1 is the ring path (n % 4
// == 0, h, g and flow on 16 bytes; grid (gx, 1), block (256, 1), kStages
// stages, kRingBytes of shared memory), ring = 0 the ragged loop (grid
// (ceil(strips / 2), p) with p <= 65535, block (32, 8), no stages, no dynamic
// shared memory).
extern "C" int qap_row_min_launch(const void* h, const void* g, const void* flow, const void* cur,
                                  long long cur_stride, void* rmin, void* rarg, int p, int n, int ring,
                                  int grid_x, int grid_y, int block_x, int block_y, int stages, int smem_bytes,
                                  void* stream) {
  if (p < 1 || n < 1 || grid_x < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (n + kT - 1) / kT;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  const float* gf = static_cast<const float*>(g);
  const float* ff = static_cast<const float*>(flow);
  const float* cf = static_cast<const float*>(cur);
  float* rm = static_cast<float*>(rmin);
  long long* ra = static_cast<long long*>(rarg);
  if (ring) {
    const bool aligned = n % 4 == 0 && (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(g) |
                                        reinterpret_cast<uintptr_t>(flow)) % 16 == 0;
    if (!aligned || grid_y != 1 || block_x != kThreads || block_y != 1 || stages != kStages ||
        smem_bytes != kRingBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    qap_row_min_ring_kernel<<<dim3(grid_x, 1), dim3(kThreads), kRingBytes, s>>>(hf, gf, ff, cf, cur_stride, rm, ra,
                                                                                  p, n);
  } else {
    if (p > kMaxLanes || grid_x != (strips + 1) / 2 || grid_y != p || block_x != kWarp || block_y != kWarps ||
        stages != 0 || smem_bytes != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    qap_row_min_kernel<<<dim3(grid_x, grid_y), dim3(kWarp, kWarps), 0, s>>>(hf, gf, ff, cf, cur_stride, rm, ra, n);
  }
  return static_cast<int>(cudaGetLastError());
}
