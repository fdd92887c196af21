// The block pick on Hopper (sm_90a): K3, `block_pick`.
//
// Replaces no Pallas kernel.  It stands for the fusion that XLA makes of the
// JAX package's N-Queens candidate scores (constraint_solver_tpu/ops/lex.py:30-34
// `make_score`, called by models/nqueens.py:353) with the reductions that read
// them in the jitted descent (core/local_search.py:126 `lex_argmin` of a retry,
// :144 the first pick, :263 the pick's score): the [A·n, 2] score block is never
// written.  The port's neighborhood hands the engine B1's row block as it is
// (ops/nqueens_kernel.py): hard [P, R, C] with a soft channel that is
// identically 0, each row's minimum and the first index of it, and a validity
// per row.  For each lane p, with an exclusion list excl[p, :E] (-1 marks an
// empty slot; any value that is no flat index never matches), K3 writes
//
//   out[p] = lex_argmin over i = j·C + k of (hard[p, j, k], 0),
//            over the i with row_valid[p, j] and i not in excl[p],
//
// with the port's lex_argmin semantics (ops/lex.py): the lowest flat index among
// the minima, and 0 when the minimum is +inf or NaN (an entry that no candidate
// beats, as when the lane has no candidate left: every entry then ties at +inf).
//
// The algorithm:
// - row j's candidate is (row_min[j], j·C + row_arg[j]).  row_arg is the first
//   index of the row's minimum, so unless it is itself excluded it is still the
//   row's first minimum once the exclusions are removed;
// - only a row whose row_arg is excluded is queued and scanned again, skipping
//   the excluded entries; there are at most E such rows, so with no exclusion
//   (the first pick) the kernel reads [P, R] and no entry of the block;
// - every (value, index) is folded lower value first, then lower index: a total
//   order in which -0.0 ties 0.0, so the fold's order and the way the work is
//   cut change nothing.  A NaN candidate makes the lane's answer 0, as the plain
//   version's NaN minimum does.
//
// Precondition, which B1 and the port's matrix forms meet: row_min[p, j] is the
// minimum of hard[p, j, :] and row_arg[p, j] the first index holding it (NaN
// counting as the minimum, as torch.amin and argmin count it).  Under it the
// kernel equals the plain version bit for bit for any float.
//
// What bounds it on this card.  The first pick moves 9 bytes a row (115 KB at
// (256, 50, 1000), 0.03 us at 3.35 TB/s): it is a launch and sits at the launch
// floor, a kernel of its own with one block of kPickThreads a lane.  A retry rescans at most E rows a
// lane (8 rows of 16,384 at (16, 64, 16384): 8 MB, 2.5 us), and what holds it
// back is latency, not bandwidth: with one block a lane, 16 lanes stream from
// 16 of the 132 SMs, and a rescan that walks its rows one after another pays
// one round trip and two barriers a row.  So a retry (kRetryThreads a block):
// - reads each thread's first row while the exclusions come in, then finds
//   the queued rows, each with the run of its excluded columns, in one pass
//   over [P, R], while the threads of the exclusion slots sort those columns
//   by flat index; only a cluster then puts the queue in row order (one
//   thread per queued row, one more barrier), so that its blocks cut the
//   same flat space;
// - sees the queued rows as one flat space of items (queued row, 16-byte
//   column group) and has each thread issue kUnroll items' loads (16 KB a
//   block, four blocks an SM at 64 registers) before it folds any; an item's
//   excluded entries become +inf, and its first minimum is folded once;
// - spreads a lane over a thread-block cluster of S blocks when lanes are few
//   and rows long (S from ops/block_pick.py `_launch_plan`, sized by the one
//   row a lane that the solves' retries rescan: at (16, 64, 16384) S = 8, 128
//   blocks, where one row takes 8.2 us at S = 1 and 5.0 us at S = 8 on an
//   NVIDIA H100 80GB HBM3 at 700 W).  Block rank b folds the b-th contiguous slice of the flat space
//   (rank 0 also the rows' first minima) and writes its (value, index, NaN
//   flag) into rank 0's shared memory (distributed shared memory,
//   `map_shared_rank`) once a first cluster barrier shows every block
//   started; rank 0 waits on a second one and writes out[p].  No scratch
//   tensor, no atomics in device memory, no second launch: a cluster launch
//   is one kernel node, so it replays in a CUDA graph like any other.
// What is left is mostly fixed cost: the launch, the cluster's barriers and
// two dependent round trips (the row pass, then the rescan); with nothing to
// rescan a cluster of 8 costs about 1 us more than one block.  chip_smoke.py
// phase 2e times a retry at (16, 64, 16384) with nothing to rescan and with 1,
// 3 and 8 rows a lane, those of 0, 1 and 8 rows at every S up to 8.
//
// The C entry launches on `stream` without synchronising and returns
// cudaGetLastError() (or the launch's own error).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kPickThreads = 128;   // threads of a block with no exclusion (the first pick): rows only
constexpr int kRetryThreads = 256;  // threads of a block with exclusions, which may rescan rows
constexpr int kUnroll = 4;          // 16-byte items a thread loads before it folds any: 16 KB a block
constexpr int kMaxExcl = 256;       // exclusion slots a lane (ops/block_pick.py MAX_EXCL)
constexpr int kMaxSlices = 8;       // blocks a lane: the portable cluster size
constexpr unsigned kNoIndex = 0xFFFFFFFFu;  // above every flat index: r · c < 2^31

// The cluster barrier in two halves (PTX barrier.cluster): every thread of
// every block of the cluster arrives, and a wait returns once all have.  The
// plain arrive releases this thread's writes (shared memory of other blocks
// included) to the threads that wait; the relaxed one orders nothing.
__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }

// (v, i) replaces (bv, bi) when lower, or equal at a lower index.
__device__ __forceinline__ void fold(float& bv, unsigned& bi, float v, unsigned i) {
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// A warp's (value, index) pairs folded into every lane of it.
__device__ __forceinline__ void warp_fold(float& bv, unsigned& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, bv, off);
    const unsigned oi = __shfl_xor_sync(0xFFFFFFFFu, bi, off);
    fold(bv, bi, ov, oi);
  }
}

// An item's entries: entry d set to +inf, its NaN test, and its first minimum
// (value, entry).  An excluded entry set to +inf never wins: if nothing lower
// is left, the lane's minimum is +inf and its pick 0 either way.
__device__ __forceinline__ void set_inf(float4& x, unsigned d) {
  x.x = d == 0 ? CUDART_INF_F : x.x;
  x.y = d == 1 ? CUDART_INF_F : x.y;
  x.z = d == 2 ? CUDART_INF_F : x.z;
  x.w = d == 3 ? CUDART_INF_F : x.w;
}
__device__ __forceinline__ void set_inf(float& x, unsigned) { x = CUDART_INF_F; }
__device__ __forceinline__ bool has_nan(const float4& x) {
  return (x.x != x.x) | (x.y != x.y) | (x.z != x.z) | (x.w != x.w);
}
__device__ __forceinline__ bool has_nan(float x) { return x != x; }
__device__ __forceinline__ float first_min(const float4& x, unsigned& w) {
  float m = x.x;
  w = 0;
  if (x.y < m) m = x.y, w = 1;
  if (x.z < m) m = x.z, w = 2;
  if (x.w < m) m = x.w, w = 3;
  return m;
}
__device__ __forceinline__ float first_min(float x, unsigned& w) {
  w = 0;
  return x;
}

// Item (q, k) advanced by n items (k < cw): past the end of row q into the next
// rows, by a division only where a row holds fewer than n items.
__device__ __forceinline__ void step(unsigned& q, unsigned& k, unsigned cw, unsigned n) {
  k += n;
  if (k < cw) return;
  if (cw >= n) {
    k -= cw;
    ++q;
  } else {
    const unsigned d = k / cw;
    q += d;
    k -= d * cw;
  }
}

// The rescan of one block's slice [lo, hi) of the flat space of items: item i
// is column group i % cw of queued row qrow[i / cw], kW entries of type Item.
// Queued row q's excluded columns are s_xcol[qlo[q] .. qhi[q]).
// Each thread steps through its items by kThreads.
template <int kThreads, int kU, typename Item>
__device__ __forceinline__ void rescan(const float* __restrict__ hard, long long lane_row0, int c, unsigned cw,
                                       unsigned lo, unsigned hi, const int* qrow, const int* qlo,
                                       const int* qhi, const int* s_xcol, float& bv, unsigned& bi, int& nan) {
  constexpr unsigned kW = sizeof(Item) / sizeof(float);
  for (unsigned base = lo + threadIdx.x; base < hi; base += kThreads * kU) {
    const unsigned q0 = base / cw, k0 = base - q0 * cw;
    Item x[kU];
    unsigned q = q0, k = k0;
#pragma unroll
    for (int u = 0; u < kU; ++u) {  // every load issued before any is folded
      if (base + u * kThreads < hi) {
        x[u] = __ldg(reinterpret_cast<const Item*>(hard + (lane_row0 + qrow[q]) * c) + k);
      }
      step(q, k, cw, kThreads);
    }
    q = q0, k = k0;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (base + u * kThreads >= hi) break;
      const unsigned col0 = k * kW;
      for (int s = qlo[q]; s < qhi[q]; ++s) {  // the row's excluded columns, mostly one
        const unsigned d = static_cast<unsigned>(s_xcol[s]) - col0;
        if (d < kW) set_inf(x[u], d);
      }
      nan |= has_nan(x[u]);
      unsigned w;
      const float m = first_min(x[u], w);
      fold(bv, bi, m, static_cast<unsigned>(qrow[q]) * c + col0 + w);
      step(q, k, cw, kThreads);
    }
  }
}

// The block's fold at thread 0 (the NaN flag OR-ed over the block).
template <int kThreads>
__device__ __forceinline__ void block_fold(float& bv, unsigned& bi, int& nan, float* s_v, unsigned* s_i) {
  const int t = threadIdx.x;
  nan = __syncthreads_or(nan);
  warp_fold(bv, bi);
  if ((t & 31) == 0) {
    s_v[t >> 5] = bv;
    s_i[t >> 5] = bi;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kThreads / 32; ++w) fold(bv, bi, s_v[w], s_i[w]);
  }
}

// The first pick (no exclusion): every valid row's first minimum, one block a lane.
__global__ void __launch_bounds__(kPickThreads)
block_pick_first_kernel(const unsigned char* __restrict__ row_valid, const float* __restrict__ row_min,
                        const int* __restrict__ row_arg, long long* __restrict__ out, int r, int c) {
  __shared__ float s_v[kPickThreads / 32];
  __shared__ unsigned s_i[kPickThreads / 32];
  const long long lane_row0 = static_cast<long long>(blockIdx.x) * r;
  float bv = CUDART_INF_F;
  unsigned bi = kNoIndex;
  int nan = 0;
  for (int j = threadIdx.x; j < r; j += kPickThreads) {
    if (!row_valid[lane_row0 + j]) continue;
    const float v = row_min[lane_row0 + j];
    if (v != v) {
      nan = 1;
    } else {
      fold(bv, bi, v, static_cast<unsigned>(j) * c + row_arg[lane_row0 + j]);
    }
  }
  block_fold<kPickThreads>(bv, bi, nan, s_v, s_i);
  if (threadIdx.x == 0) out[blockIdx.x] = (nan || !(bv < CUDART_INF_F)) ? 0 : bi;
}

// A retry: `slices` blocks a lane, in a cluster when more than one.
__global__ void __launch_bounds__(kRetryThreads, 4)
block_pick_retry_kernel(const float* __restrict__ hard, const unsigned char* __restrict__ row_valid,
                        const float* __restrict__ row_min, const int* __restrict__ row_arg,
                        const long long* __restrict__ excl, long long* __restrict__ out, int r, int c, int e,
                        int vec, int slices) {
  constexpr int kThreads = kRetryThreads;
  __shared__ long long s_excl[kMaxExcl];  // the lane's exclusion slots
  __shared__ int s_xcol[kMaxExcl];        // the columns of the slots that are flat indices, by flat index
  __shared__ int s_rows[kMaxExcl];        // queued rows, in the order found
  __shared__ int s_lo[kMaxExcl];          // queued row u's excluded columns are s_xcol[s_lo[u] .. s_hi[u])
  __shared__ int s_hi[kMaxExcl];
  __shared__ int s_qrow[kMaxExcl];        // the same in row order, for a cluster
  __shared__ int s_qlo[kMaxExcl];
  __shared__ int s_qhi[kMaxExcl];
  __shared__ int s_nrows;
  __shared__ float s_v[kThreads / 32];
  __shared__ unsigned s_i[kThreads / 32];
  __shared__ float s_part_v[kMaxSlices];  // every block's fold, in cluster rank 0's shared memory
  __shared__ unsigned s_part_i[kMaxSlices];
  __shared__ int s_part_nan[kMaxSlices];

  const int t = threadIdx.x;
  // A cluster is `slices` consecutive blocks of the 1-D grid: one lane.  Its
  // blocks arrive at once; they wait only before they write to rank 0.
  const unsigned rank = slices > 1 ? cg::this_cluster().block_rank() : 0;
  if (slices > 1) cluster_arrive_relaxed();
  const long long lane = slices == 1 ? blockIdx.x : blockIdx.x / slices;
  const long long lane_row0 = lane * r;
  const long long width = static_cast<long long>(r) * c;
  // A thread's first row is read while the exclusions come in.
  bool valid = false;
  int arg = 0;
  float row_v = 0.0f;
  if (t < r) {
    valid = row_valid[lane_row0 + t];
    arg = row_arg[lane_row0 + t];
    row_v = row_min[lane_row0 + t];
  }
  for (int k = t; k < e; k += kThreads) s_excl[k] = excl[lane * e + k];
  if (t == 0) s_nrows = 0;
  __syncthreads();

  float bv = CUDART_INF_F;
  unsigned bi = kNoIndex;
  int nan = 0;
  // Each valid row's first minimum (folded by rank 0), or the row queued for a rescan.
  for (int j = t; j < r; j += kThreads) {
    if (j != t) {
      valid = row_valid[lane_row0 + j];
      arg = row_arg[lane_row0 + j];
      row_v = row_min[lane_row0 + j];
    }
    if (!valid) continue;
    const unsigned flat = static_cast<unsigned>(j) * c + arg;
    bool hit = false;
    for (int k = 0; k < e; ++k) hit |= s_excl[k] == flat;
    if (hit) {  // distinct rows, at most E of them; the run of their excluded columns in s_xcol
      const long long first = static_cast<long long>(j) * c, last = first + c;
      int a = 0, b = 0;
      for (int k = 0; k < e; ++k) {
        const long long y = s_excl[k];
        a += y >= 0 && y < first;
        b += y >= 0 && y < last;
      }
      const int u = atomicAdd(&s_nrows, 1);
      s_rows[u] = j;
      s_lo[u] = a;
      s_hi[u] = b;
      continue;
    }
    if (rank != 0) continue;
    if (row_v != row_v) {
      nan = 1;
    } else {
      fold(bv, bi, row_v, flat);
    }
  }
  // The exclusions that are flat indices, by flat index (ties by slot): the
  // columns of each row's excluded entries in a run.
  for (int k = t; k < e; k += kThreads) {
    const long long x = s_excl[k];
    if (x < 0 || x >= width) continue;
    int pos = 0;
    for (int u = 0; u < e; ++u) {
      const long long y = s_excl[u];
      pos += y >= 0 && y < width && (y < x || (y == x && u < k));
    }
    s_xcol[pos] = static_cast<int>(x) % c;
  }
  __syncthreads();

  const int nrows = s_nrows;
  if (nrows > 0) {  // the same in every block of the lane
    const int* qrow = s_rows;
    const int* qlo = s_lo;
    const int* qhi = s_hi;
    if (slices > 1) {  // every block of a cluster cuts the same flat space: the queue in row order
      for (int u = t; u < nrows; u += kThreads) {
        const int j = s_rows[u];
        int pos = 0;
        for (int v = 0; v < nrows; ++v) pos += s_rows[v] < j;
        s_qrow[pos] = j;
        s_qlo[pos] = s_lo[u];
        s_qhi[pos] = s_hi[u];
      }
      __syncthreads();
      qrow = s_qrow;
      qlo = s_qlo;
      qhi = s_qhi;
    }
    // This block's contiguous slice of the queued rows' items.
    const unsigned cw = vec ? c / 4 : c;
    const unsigned long long total = static_cast<unsigned long long>(nrows) * cw;
    const unsigned lo = static_cast<unsigned>(total * rank / slices);
    const unsigned hi = static_cast<unsigned>(total * (rank + 1) / slices);
    if (vec) {  // c % 4 == 0 and the block on 16 bytes: every row starts on 16 bytes
      rescan<kThreads, kUnroll, float4>(hard, lane_row0, c, cw, lo, hi, qrow, qlo, qhi, s_xcol, bv, bi, nan);
    } else {  // as many bytes in flight, 4 at a time
      rescan<kThreads, 4 * kUnroll, float>(hard, lane_row0, c, cw, lo, hi, qrow, qlo, qhi, s_xcol, bv, bi, nan);
    }
  }

  block_fold<kThreads>(bv, bi, nan, s_v, s_i);
  if (slices == 1) {
    if (t == 0) out[lane] = (nan || !(bv < CUDART_INF_F)) ? 0 : bi;
    return;
  }
  // The cluster's merge.  Once the first barrier is complete every block of
  // the cluster has started, so rank 0's shared memory exists: each block's
  // thread 0 writes its fold into rank 0's slot of its rank (distributed
  // shared memory), and the second arrive releases it.  Rank 0 waits for the
  // second barrier, its first warp folds the slots and writes the lane's pick.
  // No other block reads another's shared memory, so none waits to exit.
  cluster_wait();
  if (t == 0) {
    cg::cluster_group cluster = cg::this_cluster();
    *cluster.map_shared_rank(&s_part_v[rank], 0) = bv;
    *cluster.map_shared_rank(&s_part_i[rank], 0) = bi;
    *cluster.map_shared_rank(&s_part_nan[rank], 0) = nan;
  }
  cluster_arrive();
  if (rank != 0) return;
  cluster_wait();
  if (t < 32) {
    float v = CUDART_INF_F;
    unsigned i = kNoIndex;
    int n = 0;
    if (t < slices) {
      v = s_part_v[t];
      i = s_part_i[t];
      n = s_part_nan[t];
    }
    warp_fold(v, i);
    n = __any_sync(0xFFFFFFFFu, n);
    if (t == 0) out[lane] = (n || !(v < CUDART_INF_F)) ? 0 : i;
  }
}

}  // namespace

// Shapes: hard float [p, r, c], row_valid bool [p, r], row_min float [p, r],
// row_arg int32 [p, r], excl int64 [p, e] (unread when e == 0), out int64 [p],
// all contiguous; p, r, c >= 1, 0 <= e <= kMaxExcl, r · c < 2^31.
// vec = 1 reads the rescanned rows 16 bytes at a time and needs c % 4 == 0 and
// hard on 16 bytes.  slices = S blocks a lane, 1 when e == 0.  e == 0: the
// first-pick kernel, grid (p), block (kPickThreads); else the retry kernel,
// grid (p · S), block (kRetryThreads), in clusters of (S, 1, 1) when S > 1
// Static shared memory only.
extern "C" int block_pick_launch(const void* hard, const void* row_valid, const void* row_min, const void* row_arg,
                                 const void* excl, void* out, int p, int r, int c, int e, int vec, int slices,
                                 void* stream) {
  if (p < 1 || r < 1 || c < 1 || e < 0 || e > kMaxExcl || slices < 1 || slices > kMaxSlices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((e == 0 && slices != 1) || static_cast<long long>(p) * slices > 0x7FFFFFFFLL ||
      static_cast<long long>(r) * c > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec && (c % 4 != 0 || reinterpret_cast<uintptr_t>(hard) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hard);
  const unsigned char* rv = static_cast<const unsigned char*>(row_valid);
  const float* rm = static_cast<const float*>(row_min);
  const int* ra = static_cast<const int*>(row_arg);
  const long long* ex = static_cast<const long long*>(excl);
  long long* o = static_cast<long long*>(out);
  if (e == 0) {
    block_pick_first_kernel<<<dim3(p), dim3(kPickThreads), 0, s>>>(rv, rm, ra, o, r, c);
  } else if (slices == 1) {
    block_pick_retry_kernel<<<dim3(p), dim3(kRetryThreads), 0, s>>>(h, rv, rm, ra, ex, o, r, c, e, vec, 1);
  } else {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(p * slices);
    config.blockDim = dim3(kRetryThreads);
    config.dynamicSmemBytes = 0;
    config.stream = s;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = slices;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    config.attrs = cluster;
    config.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&config, block_pick_retry_kernel, h, rv, rm, ra, ex, o, r, c, e, vec, slices);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
