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
// The algorithm (one block a lane: kPickThreads threads with no exclusion, else
// kRetryThreads, so that a rescan keeps enough loads in flight):
// - row j's candidate is (row_min[j], j·C + row_arg[j]).  row_arg is the first
//   index of the row's minimum, so unless it is itself excluded it is still the
//   row's first minimum once the exclusions are removed;
// - only a row whose row_arg is excluded is scanned again, skipping the excluded
//   entries; there are at most E such rows, so with no exclusion (the first pick)
//   the kernel reads [P, R] and no entry of the block;
// - each thread folds its candidates into one (value, index), lower value first,
//   then lower index: a total order, so the fold's order changes nothing; a warp
//   shuffle and a merge through shared memory give the block's.  A NaN candidate
//   makes the lane's answer 0, as the plain version's NaN minimum does.
//
// Precondition, which B1 and the port's matrix forms meet: row_min[p, j] is the
// minimum of hard[p, j, :] and row_arg[p, j] the first index holding it (NaN
// counting as the minimum, as torch.amin and argmin count it).  Under it the
// kernel equals the plain version bit for bit for any float.
//
// What bounds it on this card: neither bytes nor operations.  The first pick
// moves 9 bytes a row (115 KB at (256, 50, 1000), 0.03 us at 3.35 TB/s); a
// retry rescans at most E rows (8 rows of 16,384 at (16, 64, 16384): 8 MB, 2.5
// us).  What it costs is a launch, in place of the plain chain's mask passes and
// reductions over the [P, A·n] block and the stack that wrote the block.  A
// lane's rescans run on its one block, so with few lanes (P = 16) they use few
// of the card's 132 SMs and wait on memory latency.
//
// The C entry launches on `stream` without synchronising and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kPickThreads = 128;   // threads of a block with no exclusion (the first pick): rows only
constexpr int kRetryThreads = 512;  // threads of a block with exclusions, which may rescan rows
constexpr int kUnroll = 4;          // 16-byte loads a thread keeps in flight in a rescan
constexpr int kMaxExcl = 256;  // exclusion slots a lane (ops/block_pick.py MAX_EXCL)
constexpr long long kNoIndex = 0x7FFFFFFFFFFFFFFFLL;

// (v, i) replaces (bv, bi) when lower, or equal at a lower index.
__device__ __forceinline__ void fold(float& bv, long long& bi, float v, long long i) {
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// Entry k of a rescanned row: skipped when excluded (one of the row's m
// excluded columns), a NaN flags the lane.
__device__ __forceinline__ void consider(float& bv, long long& bi, int& nan, float v, int k, long long flat0,
                                         const int* s_cols, int m) {
  bool hit = false;
  for (int q = 0; q < m; ++q) hit |= s_cols[q] == k;
  if (hit) return;
  if (v != v) {
    nan = 1;
  } else {
    fold(bv, bi, v, flat0 + k);
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
block_pick_kernel(const float* __restrict__ hard, const unsigned char* __restrict__ row_valid,
                  const float* __restrict__ row_min, const int* __restrict__ row_arg,
                  const long long* __restrict__ excl, long long* __restrict__ out, int r, int c, int e, int vec) {
  constexpr int kWarps = kThreads / 32;
  __shared__ long long s_excl[kMaxExcl];
  __shared__ int s_rows[kMaxExcl];
  __shared__ int s_nrows;
  __shared__ int s_cols[kMaxExcl];
  __shared__ int s_ncols;
  __shared__ float s_v[kWarps];
  __shared__ long long s_i[kWarps];

  const int t = threadIdx.x;
  const long long lane_row0 = static_cast<long long>(blockIdx.x) * r;
  for (int k = t; k < e; k += kThreads) s_excl[k] = excl[static_cast<long long>(blockIdx.x) * e + k];
  if (t == 0) s_nrows = 0;
  __syncthreads();

  float bv = CUDART_INF_F;
  long long bi = kNoIndex;
  int nan = 0;
  // Each valid row's first minimum, or the row queued for a rescan.
  for (int j = t; j < r; j += kThreads) {
    if (!row_valid[lane_row0 + j]) continue;
    const long long flat = static_cast<long long>(j) * c + row_arg[lane_row0 + j];
    bool hit = false;
    for (int k = 0; k < e; ++k) hit |= s_excl[k] == flat;
    if (hit) {
      s_rows[atomicAdd(&s_nrows, 1)] = j;  // distinct rows, at most E of them
      continue;
    }
    const float v = row_min[lane_row0 + j];
    if (v != v) {
      nan = 1;
    } else {
      fold(bv, bi, v, flat);
    }
  }
  __syncthreads();

  // The queued rows, each spread over the block: first the row's excluded
  // columns, then kUnroll loads a thread in flight before any is folded.
  const int nrows = s_nrows;
  for (int q = 0; q < nrows; ++q) {
    const int j = s_rows[q];
    const long long flat0 = static_cast<long long>(j) * c;
    const float* row = hard + (lane_row0 + j) * c;
    if (t == 0) {
      int m = 0;
      for (int k = 0; k < e; ++k) {
        if (s_excl[k] >= flat0 && s_excl[k] < flat0 + c) s_cols[m++] = static_cast<int>(s_excl[k] - flat0);
      }
      s_ncols = m;
    }
    __syncthreads();
    const int m = s_ncols;
    if (vec) {  // c % 4 == 0 and the block on 16 bytes: every row starts on 16 bytes
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const int c4 = c / 4;
      for (int k0 = t; k0 < c4; k0 += kThreads * kUnroll) {
        float4 x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k0 + u * kThreads < c4) x[u] = row4[k0 + u * kThreads];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k4 = k0 + u * kThreads;
          if (k4 >= c4) break;
          consider(bv, bi, nan, x[u].x, 4 * k4, flat0, s_cols, m);
          consider(bv, bi, nan, x[u].y, 4 * k4 + 1, flat0, s_cols, m);
          consider(bv, bi, nan, x[u].z, 4 * k4 + 2, flat0, s_cols, m);
          consider(bv, bi, nan, x[u].w, 4 * k4 + 3, flat0, s_cols, m);
        }
      }
    } else {
      for (int k0 = t; k0 < c; k0 += kThreads * kUnroll) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k0 + u * kThreads < c) x[u] = row[k0 + u * kThreads];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k0 + u * kThreads >= c) break;
          consider(bv, bi, nan, x[u], k0 + u * kThreads, flat0, s_cols, m);
        }
      }
    }
    __syncthreads();  // every thread is done with s_cols before the next row writes it
  }

  nan = __syncthreads_or(nan);
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, bv, off);
    const long long oi = __shfl_xor_sync(0xFFFFFFFFu, bi, off);
    fold(bv, bi, ov, oi);
  }
  if ((t & 31) == 0) {
    s_v[t >> 5] = bv;
    s_i[t >> 5] = bi;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kWarps; ++w) fold(bv, bi, s_v[w], s_i[w]);
    out[blockIdx.x] = (nan || !(bv < CUDART_INF_F)) ? 0 : bi;
  }
}

}  // namespace

// Shapes: hard float [p, r, c], row_valid bool [p, r], row_min float [p, r],
// row_arg int32 [p, r], excl int64 [p, e] (unread when e == 0), out int64 [p],
// all contiguous; p, r, c >= 1, 0 <= e <= kMaxExcl.  vec = 1 reads the rescanned
// rows 16 bytes at a time and needs c % 4 == 0 and hard on 16 bytes.  Grid (p),
// block (kPickThreads) when e == 0, else (kRetryThreads); static shared memory only.
extern "C" int block_pick_launch(const void* hard, const void* row_valid, const void* row_min, const void* row_arg,
                                 const void* excl, void* out, int p, int r, int c, int e, int vec, void* stream) {
  if (p < 1 || r < 1 || c < 1 || e < 0 || e > kMaxExcl) return static_cast<int>(cudaErrorInvalidValue);
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
    block_pick_kernel<kPickThreads><<<dim3(p), dim3(kPickThreads), 0, s>>>(h, rv, rm, ra, ex, o, r, c, e, vec);
  } else {
    block_pick_kernel<kRetryThreads><<<dim3(p), dim3(kRetryThreads), 0, s>>>(h, rv, rm, ra, ex, o, r, c, e, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
