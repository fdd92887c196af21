// The masked N-Queens move on Hopper (sm_90a): K4, `nqueens_move`.
//
// Replaces no Pallas kernel.  It stands for the fusion that XLA makes of the
// JAX package's N-Queens move (constraint_solver_tpu/models/nqueens.py:375-406
// `apply_move`) with the whole-state selects that consume it in the jitted
// descent (core/local_search.py:107-108 `_select`, for the best at :282-283,
// the step at :290, and the lanes still running by vmap's batching of the
// while_loop at :305-316): no pass over the whole state is left there.  The
// port's descent with `Problem.in_place` (core/local_search.py) writes the
// move into the carry's own buffers under the lane mask and carries its best
// as the board; K4 is that write.  For each lane p with mask[p], with
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
// A lane outside mask is not written at all.  Every value is a small integer
// in float32, so the kernel equals the plain version (ops/nqueens_move.py
// `nqueens_move_ref`) bit for bit: Δj is summed as an integer and added once,
// so no -0.0 can appear, and where Δj is 0 the kernel leaves cs[j] as it is
// while the plain version adds +0.0, which is the same for every cs[j] but
// -0.0.  No state holds a -0.0 in cs: build_state's sums of integers and
// these moves give +0.0.
//
// The design, one block a lane (grid P).  The kernel is a chain of dependent
// memory round trips more than a stream of bytes (a lane is 8 KB at n = 1000),
// so it is laid out to keep that chain short:
// - every thread reads mask[p] (one broadcast load) while thread 0 reads
//   idx[p] beside it; a lane outside the mask returns before it loads more;
// - every thread then loads its columns' rows[j] (up to kUnroll each, all in
//   flight at once) while thread 0 decodes the move (cols, then rows[col])
//   into shared memory; then one barrier.  Nobody writes rows before it, so
//   every load before it reads the old board, and every reader of r_old has
//   it before thread 0 writes rows[col];
// - thread 0 loads its six counter cells right after the barrier, in flight
//   with the pass;
// - the pass computes Δj for its columns, j != col, then loads every cs[j]
//   with Δj != 0 at once (the columns that share a line with the old or the
//   new square, a handful a lane) and writes them: cs is touched nowhere else;
// - thread 0 then writes the counters from its registers (a cell that is both
//   old and new, r_old == r_new, gets (x - 1) + 1 once), rows[col] and
//   cs[col].  The pass skips j = col and no other thread touches the counter
//   cells, so these writes race with nothing and need no second barrier.
// A lane is 8 bytes a column (rows read) plus those few cells.  When
// n > threads * kUnroll (n > 16,384) the pass loops, loading each further
// chunk of rows after the barrier.  Splitting a lane over several blocks would
// need the decoded move passed in (the decode must precede the write of
// rows[col] in every block); that is left for later.
//
// A lane whose idx, column or old row is out of range (no engine sends one;
// the plain version raises on it) is left as it is.
//
// The C entry launches on `stream` without synchronising and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kUnroll = 16;       // columns a thread loads before it computes any
constexpr int kMaxThreads = 1024; // a block's threads at most (ops/nqueens_move.py MAX_THREADS)

// rows[j] of the thread's kUnroll columns from `base` (0 past n), all loads in flight at once.
__device__ __forceinline__ void load_rows(int (&r)[kUnroll], const long long* __restrict__ lrows, int base, int n) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = base + u * static_cast<int>(blockDim.x);
    r[u] = j < n ? static_cast<int>(lrows[j]) : 0;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
nqueens_move_kernel(long long* __restrict__ rows, float* __restrict__ rc, float* __restrict__ dc,
                    float* __restrict__ ac, float* __restrict__ cs, const long long* __restrict__ cols,
                    const long long* __restrict__ idx, const unsigned char* __restrict__ mask, int n, int a,
                    int col_stride) {
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  long long flat = 0;
  if (tid == 0) flat = idx[p];  // in flight with the mask's load
  if (!mask[p]) return;         // the whole block: nothing of this lane is written
  __shared__ int move[3];       // col, r_old, r_new; col = -1: out of range, nothing written
  long long* lrows = rows + static_cast<long long>(p) * n;
  float* lcs = cs + static_cast<long long>(p) * n;
  int r[kUnroll];
  load_rows(r, lrows, tid, n);  // the old board, col's row too: nobody writes rows before the barrier
  if (tid == 0) {
    int col = -1, r_old = 0, r_new = 0;
    if (flat >= 0 && flat < static_cast<long long>(a) * n) {
      const long long k = flat / n;
      const long long c = cols[static_cast<long long>(p) * col_stride + k];
      if (c >= 0 && c < n) {
        const long long rr = lrows[c];
        if (rr >= 0 && rr < n) {
          col = static_cast<int>(c);
          r_old = static_cast<int>(rr);
          r_new = static_cast<int>(flat - k * n);
        }
      }
    }
    move[0] = col;
    move[1] = r_old;
    move[2] = r_new;
  }
  __syncthreads();
  const int col = move[0];
  if (col < 0) return;
  const int r_old = move[1], r_new = move[2];
  const int d_old = r_old - col + n - 1, d_new = r_new - col + n - 1;
  const int a_old = r_old + col, a_new = r_new + col;
  const long long table = 2LL * n - 1;
  float* lrc = rc + static_cast<long long>(p) * n;
  float* ldc = dc + static_cast<long long>(p) * table;
  float* lac = ac + static_cast<long long>(p) * table;
  float cnt[6] = {};  // rc[r_old], rc[r_new], dc[d_old], dc[d_new], ac[a_old], ac[a_new], loaded beside the pass
  if (tid == 0) {
    cnt[0] = lrc[r_old];
    cnt[1] = lrc[r_new];
    cnt[2] = ldc[d_old];
    cnt[3] = ldc[d_new];
    cnt[4] = lac[a_old];
    cnt[5] = lac[a_new];
  }

  const int step = static_cast<int>(blockDim.x) * kUnroll;
  for (int base = tid; base < n; base += step) {
    if (base != tid) load_rows(r, lrows, base, n);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // r[u] becomes Δj
      const int j = base + u * static_cast<int>(blockDim.x);
      const int rj = r[u], dj = rj - j + n - 1, aj = rj + j;
      const int delta = (rj == r_new) - (rj == r_old) + (dj == d_new) - (dj == d_old) + (aj == a_new) -
                        (aj == a_old);
      r[u] = j < n && j != col ? delta : 0;
    }
    float c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) c[u] = r[u] != 0 ? lcs[base + u * static_cast<int>(blockDim.x)] : 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] != 0) lcs[base + u * static_cast<int>(blockDim.x)] = c[u] + static_cast<float>(r[u]);
    }
  }

  if (tid == 0) {
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
    lrows[col] = r_new;
    lcs[col] = ((rc_new - 1.0f) + (dc_new - 1.0f)) + (ac_new - 1.0f);
  }
}

extern "C" int nqueens_move_launch(void* rows, void* rc, void* dc, void* ac, void* cs, const void* cols,
                                   const void* idx, const void* mask, int p, int n, int a, int col_stride,
                                   int threads, void* stream) {
  if (p < 1 || n < 1 || a < 1 || n > (1 << 29) || col_stride < 1 || (p > 1 && col_stride < a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nqueens_move_kernel<<<dim3(p), dim3(threads), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(rows), static_cast<float*>(rc), static_cast<float*>(dc), static_cast<float*>(ac),
      static_cast<float*>(cs), static_cast<const long long*>(cols), static_cast<const long long*>(idx),
      static_cast<const unsigned char*>(mask), n, a, col_stride);
  return static_cast<int>(cudaGetLastError());
}
