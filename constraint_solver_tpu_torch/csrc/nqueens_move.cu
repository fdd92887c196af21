// The masked N-Queens move on Hopper (sm_90a): K4, `nqueens_move`.
//
// Replaces no Pallas kernel.  It stands for the fusion that XLA makes of the
// JAX package's N-Queens move (constraint_solver_tpu/models/nqueens.py:375-406
// `apply_move`) with the whole-state selects that consume it in the jitted
// descent (core/local_search.py:107-108 `_select`, for the best at :281-283,
// the step at :290, and the lanes still running by vmap's batching of the
// while_loop at :305-316): no pass over the whole state is left there.  The
// port's descent with `Problem.in_place` (core/local_search.py) writes the
// move into the carry's own buffers under the lane mask and carries its best
// as the board, written by this same launch; K4 is that write.  For each lane
// p with mask[p], with
//
//   col = cols[p, idx[p] / n],  r_new = idx[p] % n,  r_old = rows[p, col],
//   d = r - col + n - 1 (diagonal),  a = r + col (anti-diagonal),
//
// it writes, in the state's own buffers:
//
// - rows[col] = r_new;
// - rc, dc and ac: -1.0 at the old cell, then +1.0 at the new cell (a cell
//   that is both takes -1 then +1 and ends where it started);
// - cs[j] += Δj for every other column j, Δj the JAX package's six 0/1 terms
//   read against the old rows[j]: [r_j = r_new] - [r_j = r_old]
//   + [d_j = d_new] - [d_j = d_old] + [a_j = a_new] - [a_j = a_old];
// - cs[col] = ((rc'[r_new] - 1) + (dc'[d_new] - 1)) + (ac'[a_new] - 1) on the
//   updated counters, in that float order.
//
// and, when the call carries a best board (best int64[P, n], save bool[P]),
// best[p, :] = the lane's board after the move for each lane with save[p]: a
// lane outside mask (the descent's lane that hit its target) saves its board
// as it is.  A lane in neither mask is not written at all.  Every value is a
// small integer in float32, so the kernel equals the plain version
// (ops/nqueens_move.py `nqueens_move_ref`) bit for bit: Δj is summed as an
// integer and added once, so no -0.0 can appear, and where Δj is 0 the kernel
// leaves cs[j] as it is while the plain version adds +0.0, which is the same
// for every cs[j] but -0.0.  No state holds a -0.0 in cs: build_state's sums
// of integers and these moves give +0.0.
//
// What bounds it on this card.  A moving lane reads its board (8 bytes a
// column) and a handful of cells; a saving lane writes its board once more.
// That is 0.6 us at (256, 50, 1000) and at (16, 64, 16384) at 3.35 TB/s, but
// the time is set by a chain of dependent round trips (mask and idx, then
// cols[idx / n], then rows[col], then the pass), and at 16 lanes by the few
// SMs that one block a lane would leave at work.  So:
// - a lane is S blocks, one thread-block cluster of (S, 1, 1), when lanes are
//   few (S from ops/nqueens_move.py `_launch_plan`: P·S fills the SMs, S at
//   most 8, the portable cluster size, and each block at least 1024
//   columns; S = 8 at (16, 64, 16384), 1 at (256, 50, 1000)).  Block rank b
//   takes the b-th contiguous chunk of the lane's items: 16-byte pairs of
//   columns when n is even and the boards lie on 16 bytes, single columns
//   otherwise.  A block has the power of two of threads in [32, 256] that
//   gives each thread about 4 columns of its chunk (256 at both cells'
//   shapes; fewer threads a block were slower on an H100, PERF.md); each
//   thread loads up to kColumns columns at once;
// - every thread reads mask[p] and save[p]; a lane in neither returns there.
//   Rank 0's thread 0 reads idx[p] beside them and decodes the move (cols,
//   then rows[col]) while every block of the cluster has its chunk's loads in
//   flight; it then issues its six counter cells' loads at once, before any
//   barrier, so they arrive behind it;
// - rank 0 writes (col, r_old, r_new) into every rank's shared memory
//   (distributed shared memory, `map_shared_rank`), once a first phase of the
//   cluster barrier shows that every block has started; a second phase
//   releases the move to every block and orders every read of the old board
//   (rank 0's read of rows[col] included) before any write.  With S = 1 one
//   __syncthreads does both;
// - the pass computes Δj for its columns and adds it to cs[j] where Δj != 0
//   as a reduction whose result is unused (atomicAdd, RED.E.ADD.F32): no
//   round trip to read cs.  Each cell has that one writer, Δj is an integer
//   added once to a small integer held in float32, and a cell with Δj = 0 is
//   not touched, so the result is the plain version's bit for bit;
// - rank 0's thread 0 writes the counters from its registers (a cell that
//   is both old and new, r_old == r_new, gets (x - 1) + 1 once) and cs[col]
//   before its own part of the pass.  No other thread touches those cells,
//   so no further barrier;
// - the thread whose items hold col writes rows[col] = r_new (it read the old
//   value itself), and skips col in the pass; with a best board every thread
//   writes its items of the moved board into best with 16-byte stores.
// A save-only lane takes no barrier: each block copies its chunk.  When a
// block's chunk is more than threads * kColumns columns (n > 4,096 · S) the
// pass loops, loading each further part of the chunk after the barrier; the
// owner of col writes it whenever it reaches it.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 2f, from HBM) the
// all-on move takes 4.55 us at (256, 50, 1000) and 5.34 us at (16, 64, 16384)
// against a 0.62 us bound, and a launch with no lane to move 1.31 us: the
// chain of round trips, the counters and the reductions' drain, not the
// bytes, set the time.
//
// A lane whose idx, column or old row is out of range (no engine sends one;
// the plain version raises on it) is not moved; with save, best gets its
// board as it is.
//
// The C entry launches on `stream` without synchronising and returns
// cudaGetLastError() (or the launch's own error, or cudaErrorInvalidValue for
// arguments it refuses).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kColumns = 16;      // columns a thread loads before it computes any (ops/nqueens_move.py COLUMNS)
constexpr int kMaxThreads = 256;  // a block's threads at most (ops/nqueens_move.py MAX_THREADS)
constexpr int kMaxSlices = 8;     // blocks a lane: the portable cluster size (ops/nqueens_move.py MAX_SLICES)

// The cluster barrier in two halves (PTX barrier.cluster), as in block_pick.cu:
// the plain arrive releases this thread's reads and writes to the threads that
// wait; the relaxed one orders nothing.
__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }

// An item's column w, and the same column set.  An item is a 16-byte pair of
// columns (longlong2) or one column (long long).
__device__ __forceinline__ long long column(const longlong2& x, int w) { return w == 0 ? x.x : x.y; }
__device__ __forceinline__ long long column(long long x, int) { return x; }
__device__ __forceinline__ void set_column(longlong2& x, int w, long long v) {
  if (w == 0) {
    x.x = v;
  } else {
    x.y = v;
  }
}
__device__ __forceinline__ void set_column(long long& x, int, long long v) { x = v; }

// The thread's items base, base + T, ... below hi, all loads in flight at once.
template <typename Item, int kItems>
__device__ __forceinline__ void load_items(Item (&x)[kItems], const Item* __restrict__ lrows, int base, int hi) {
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = base + u * static_cast<int>(blockDim.x);
    if (i < hi) x[u] = lrows[i];
  }
}

template <typename Item>
__global__ void __launch_bounds__(kMaxThreads)
nqueens_move_kernel(long long* __restrict__ rows, float* __restrict__ rc, float* __restrict__ dc,
                    float* __restrict__ ac, float* __restrict__ cs, const long long* __restrict__ cols,
                    const long long* __restrict__ idx, const unsigned char* __restrict__ mask,
                    long long* __restrict__ best, const unsigned char* __restrict__ save, int n, int a,
                    int col_stride, int slices) {
  constexpr int kWidth = static_cast<int>(sizeof(Item) / sizeof(long long));  // columns an item
  constexpr int kItems = kColumns / kWidth;
  __shared__ int s_move[3];  // col, r_old, r_new; col = -1: out of range, nothing moved
  // A cluster is `slices` consecutive blocks of the 1-D grid: one lane.
  const int rank = slices > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long lane = blockIdx.x / slices;
  const int t = threadIdx.x;
  const bool lead = rank == 0 && t == 0;  // decodes the move and owns the counters and cs[col]
  long long flat = 0;
  if (lead) flat = idx[lane];  // in flight with the masks' loads
  const bool move = mask[lane];
  const bool keep = save != nullptr && save[lane];
  if (!move && !keep) return;  // the whole cluster: nothing of this lane is written
  if (move && slices > 1) cluster_arrive_relaxed();  // first phase: this block has started

  // This block's contiguous chunk [lo, hi) of the lane's items, and its first loads.
  const int items = n / kWidth;
  const int lo = static_cast<int>(static_cast<long long>(items) * rank / slices);
  const int hi = static_cast<int>(static_cast<long long>(items) * (rank + 1) / slices);
  long long* lrows = rows + lane * n;
  Item x[kItems];
  load_items(x, reinterpret_cast<const Item*>(lrows), lo + t, hi);  // the old board: nobody writes before the barrier

  int col = -1, r_old = 0, r_new = 0;
  const long long table = 2LL * n - 1;
  float* lrc = rc + lane * n;
  float* ldc = dc + lane * table;
  float* lac = ac + lane * table;
  float* lcs = cs + lane * n;
  float cnt[6] = {};  // rc[r_old], rc[r_new], dc[d_old], dc[d_new], ac[a_old], ac[a_new]: the lead's
  if (move) {
    if (lead) {
      if (flat >= 0 && flat < static_cast<long long>(a) * n) {
        const long long k = flat / n;
        const long long c = cols[lane * col_stride + k];
        if (c >= 0 && c < n) {
          const long long rr = lrows[c];
          if (rr >= 0 && rr < n) {
            col = static_cast<int>(c);
            r_old = static_cast<int>(rr);
            r_new = static_cast<int>(flat - k * n);
          }
        }
      }
      if (col >= 0) {  // in flight through the barrier
        cnt[0] = lrc[r_old];
        cnt[1] = lrc[r_new];
        cnt[2] = ldc[r_old - col + n - 1];
        cnt[3] = ldc[r_new - col + n - 1];
        cnt[4] = lac[r_old + col];
        cnt[5] = lac[r_new + col];
      }
      if (slices > 1) {
        cluster_wait();  // first phase complete: every block of the cluster exists
        cg::cluster_group cluster = cg::this_cluster();
        for (int b = 0; b < slices; ++b) {
          int* m = cluster.map_shared_rank(s_move, b);
          m[0] = col;
          m[1] = r_old;
          m[2] = r_new;
        }
      } else {
        s_move[0] = col;
        s_move[1] = r_old;
        s_move[2] = r_new;
      }
    }
    if (slices > 1) {
      if (!lead) cluster_wait();  // first phase
      cluster_arrive();           // second phase: releases the move and every read of the old board
      cluster_wait();
    } else {
      __syncthreads();
    }
    col = s_move[0];
    r_old = s_move[1];
    r_new = s_move[2];
    if (col < 0 && !keep) return;
  }
  const bool moving = col >= 0;
  const int d_old = r_old - col + n - 1, d_new = r_new - col + n - 1;
  const int a_old = r_old + col, a_new = r_new + col;
  Item* lbest = keep ? reinterpret_cast<Item*>(best + lane * n) : nullptr;

  if (moving && lead) {
    float rc_new, dc_new, ac_new;  // the counters at the new square after the move
    if (r_old == r_new) {          // each cell is both: -1 then +1
      rc_new = (cnt[0] - 1.0f) + 1.0f;
      dc_new = (cnt[2] - 1.0f) + 1.0f;
      ac_new = (cnt[4] - 1.0f) + 1.0f;
    } else {
      rc_new = cnt[1] + 1.0f;
      dc_new = cnt[3] + 1.0f;
      ac_new = cnt[5] + 1.0f;
      lrc[r_old] = cnt[0] - 1.0f;
      ldc[d_old] = cnt[2] - 1.0f;
      lac[a_old] = cnt[4] - 1.0f;
    }
    lrc[r_new] = rc_new;
    ldc[d_new] = dc_new;
    lac[a_new] = ac_new;
    lcs[col] = ((rc_new - 1.0f) + (dc_new - 1.0f)) + (ac_new - 1.0f);
  }

  const int step = static_cast<int>(blockDim.x) * kItems;
  for (int base = lo + t; base < hi; base += step) {
    if (base != lo + t) load_items(x, reinterpret_cast<const Item*>(lrows), base, hi);
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int i = base + u * static_cast<int>(blockDim.x);
      if (i >= hi) continue;
      if (moving) {
#pragma unroll
        for (int w = 0; w < kWidth; ++w) {
          const int j = i * kWidth + w;
          if (j == col) {  // the owner: it read the old row itself, and nobody else reads it
            lrows[col] = r_new;
            set_column(x[u], w, r_new);
            continue;
          }
          const int rj = static_cast<int>(column(x[u], w)), dj = rj - j + n - 1, aj = rj + j;
          const int delta = (rj == r_new) - (rj == r_old) + (dj == d_new) - (dj == d_old) + (aj == a_new) -
                            (aj == a_old);
          if (delta != 0) atomicAdd(lcs + j, static_cast<float>(delta));  // result unused: a reduction
        }
      }
      if (keep) lbest[i] = x[u];
    }
  }
}

}  // namespace

// Shapes: rows int64 [p, n], rc and cs float [p, n], dc and ac float [p, 2n - 1],
// cols int64 rows of `col_stride` (A used), idx int64 [p], mask bool [p],
// best int64 [p, n] and save bool [p] (both null: no best board), all on one
// device, contiguous but cols; best shares no memory with rows.  vec = 1
// reads and writes the boards 16 bytes at a time and needs n even and rows
// and best on 16 bytes.  Grid (p · slices) of `threads`, in clusters of
// (slices, 1, 1) when slices > 1.  Static shared memory only.
extern "C" int nqueens_move_launch(void* rows, void* rc, void* dc, void* ac, void* cs, const void* cols,
                                   const void* idx, const void* mask, void* best, const void* save, int p,
                                   int n, int a, int col_stride, int threads, int slices, int vec,
                                   void* stream) {
  if (p < 1 || n < 1 || a < 1 || n > (1 << 29) || col_stride < 1 || (p > 1 && col_stride < a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || slices < 1 || slices > kMaxSlices ||
      static_cast<long long>(p) * slices > 0x7FFFFFFFLL || (best == nullptr) != (save == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec && (n % 2 != 0 || reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(best) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long* r = static_cast<long long*>(rows);
  float* frc = static_cast<float*>(rc);
  float* fdc = static_cast<float*>(dc);
  float* fac = static_cast<float*>(ac);
  float* fcs = static_cast<float*>(cs);
  const long long* c = static_cast<const long long*>(cols);
  const long long* ix = static_cast<const long long*>(idx);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  long long* b = static_cast<long long*>(best);
  const unsigned char* sv = static_cast<const unsigned char*>(save);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p * slices);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = slices;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = slices > 1 ? 1 : 0;
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&config, nqueens_move_kernel<longlong2>, r, frc, fdc, fac, fcs, c, ix, m, b, sv, n, a,
                               col_stride, slices)
          : cudaLaunchKernelEx(&config, nqueens_move_kernel<long long>, r, frc, fdc, fac, fcs, c, ix, m, b, sv, n, a,
                               col_stride, slices);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
