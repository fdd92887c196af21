// The fingerprint hash on Hopper (sm_90a): K2, `fp_hash_xor` (K2a), its ring form `fp_hash_probe`
// and `fingerprint_rows` (K2b); and K7, `fp_nq_move`, the fingerprints of N-Queens candidates.
//
// Replaces no Pallas kernel.  It stands for the fusions that XLA makes of the
// JAX package's fingerprint arithmetic (constraint_solver_tpu/ops/fingerprint.py:30-95:
// `_mix32`, `position_hash_planes`, `_xor_reduce`, `fingerprint_i32`,
// `fp_update`) wherever the jitted descent uses it: each use is one pass.  For
// a position i and a value v, in uint32 and for each of the two lane salts,
//
//   h(i, v) = mix32(v ^ mix32(i ^ salt)),   mix32 = murmur3's fmix32 finalizer
//
// (fp_hash.cuh, which K5's csrc/sched_dense.cu includes too).
//
// - K2a `fp_hash_xor`: out = base ^ XOR_{k < K} h(idx_k, val_k) for both lanes,
//   K = 1..4 (position, value) terms and an optional base fingerprint, over the
//   broadcast of the operands' shapes (at most 4 dimensions).  Every operand
//   comes with its own element strides (0 on a broadcast dimension) and its
//   width (int32 or int64), so expanded views and int32 bit views are read in
//   place, with no copy.  One thread per output element computes both lanes.
// - K2b `fingerprint_rows`: for values [..., n] (at most 3 row dimensions, any
//   strides), out[r] = XOR_{j < n} h(j, values[r, j]) for both lanes: one row per
//   group of 1, 2, 4 or 8 warps, each thread XOR-ing a strided share of the row,
//   a shuffle over the warp and, for groups of several warps, a merge through
//   shared memory.  Where that grid would leave SMs idle (a few long rows: (16,
//   16384), (4, 4096)), `fingerprint_rows_split` cuts each row into parts of
//   `chunk` positions, one block a part, and each block `atomicXor`s its part's
//   XOR into the output, which the wrapper zeroes on the same stream.  XOR is
//   associative and commutative, so the order of the atomics changes nothing.
// - K2a's ring form `fp_hash_probe` (the tabu ring of core/history.py, which
//   the JAX package's jitted descent fuses: constraint_solver_tpu/core/history.py
//   TabuRing.push and is_tabu).  For each lane p: optionally the push of
//   push[p] into the lane's ring (count' = count + 1; the slot the first whose
//   two words equal push[p], else head; fps'[slot] = push[p], iters'[slot] =
//   count'; head' = head when it was present, else (head + 1) mod T), then for
//   each candidate w its fingerprint base[p] ^ cand[p, w] (or cand[p, w]) and
//   tabu[p, w] = some slot s with fps'[s] == fp on both words and iters'[s] +
//   expiry[p] >= count' (int32 sums that wrap, as torch's and XLA's do), or
//   ok[p, w] = valid[p, w] & !tabu[p, w].  The grid is (lane, chunk of
//   candidates); every block of a lane finds the push's slot (a first-match
//   reduction over the ring), stages the ring with the push applied in tiles of
//   kProbeTile slots in shared memory, keeping only the slots still alive, and
//   its candidates, held in registers, scan each tile with broadcast reads.
//   The lane's first block writes the pushed ring into new tensors: the ring
//   read is never written, so the blocks of a lane cannot race, and a CUDA graph
//   captures the launch as it captures K2a.  Fingerprints are compared on their
//   low 32 bits: the port's fingerprints hold values in [0, 2^32), on which
//   that is the plain version's int64 equality.
// - K7 `fp_nq_move`: the fingerprint after each N-Queens candidate move,
//   out[p, w] = fp[p] ^ h(col, old) ^ h(col, new) for the flat candidate
//   f = idx[p, w] of a lane whose sampled columns are cols[p, :A] and whose
//   board is rows[p, :n]: col = cols[p, f / n], new = f % n, old = rows[p,
//   col].  It stands for the fusion XLA makes of the JAX package's move_fp
//   (constraint_solver_tpu/models/nqueens.py:365-373), which the port ran as
//   five launches a pick (two divisions, two gathers, then K2a).  One thread
//   an output, both lanes; idx any strides (the exact filter's [P, A·n] is an
//   expanded iota, read with a lane stride of 0).  Candidates are flat indices
//   in [0, A·n): the plain version's floor division and remainder are C's
//   there.
//
// Inputs are taken modulo 2^32 (their low 32 bits, so a negative int32 hashes as
// its bit pattern, as the JAX package's astype(uint32) does), and outputs are
// int64 holding the uint32 value, the port's representation of a fingerprint
// (ops/fingerprint.py).  uint32 multiplication wraps exactly as the plain
// version's masked int64 product does, and XOR is associative and commutative,
// so the hash kernels equal the plain version bit for bit for any input.
//
// What bounds them on this card: neither bytes nor operations.  The solvers give
// K2a a few thousand to half a million outputs (16 bytes each) and K2b rows of
// 365 to 16,384 positions; the largest call, the roster's dense block of [64,
// 365, 20], moves 7.6 MB (2.3 us at 3.35 TB/s) and does 38 integer operations
// a term and output (36 M, 0.5 us at 67 T/s).  Most calls move a few KB, so
// what they cost is a launch: the design's aim is one launch for each use,
// in place of the plain version's 34-96 eager int64 passes, and nothing copied
// to get there.  K7 likewise: a pick moves some 50 bytes a lane; the exact
// filter's [256, 50000] writes 205 MB (61 us at 3.35 TB/s).
//
// Each C entry takes its whole plan as one array of int64 (the layouts below,
// written by ops/fingerprint.py `_hash_plan` / `_rows_plan` with the pointers
// appended), checks it, launches on `stream` without synchronising, and returns
// cudaGetLastError().  The kernels take their arguments as one struct by value,
// so a CUDA graph captures the launch with its arguments.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_hash.cuh"

namespace {

using fp_hash::kSalt0;  // the JAX package's two lane salts
using fp_hash::kSalt1;
using fp_hash::mix32;
constexpr int kDims = 4;                  // dimensions of an operand or of K2a's output
constexpr int kMaxTerms = 4;              // (position, value) terms of K2a
constexpr int kThreads = 256;             // threads of a block, both kernels
constexpr int kWarps = kThreads / 32;

// The plans' layouts (int64 entries), as ops/fingerprint.py writes them.
constexpr int kOperandLen = 6;            // pointer, 4 strides, width (1: int64, 0: int32)
constexpr int kHashPlanLen = 16 + 2 * kOperandLen * kMaxTerms;  // 64
constexpr int kRowsPlanLen = 16;
constexpr int kProbePlanLen = 36;
constexpr int kProbeTile = 1024;          // ring slots a block stages in shared memory at once
constexpr int kNqMovePlanLen = 18;

struct Operand {
  const void* ptr;
  long long stride[kDims];  // in elements; 0 on a broadcast dimension
  int wide;                 // 1: int64 elements, 0: int32
};

struct HashArgs {
  long long shape[kDims];   // the output's shape, leading dimensions of size 1
  long long numel;
  int terms;
  int has_base;
  Operand base;             // int64 [..., 2]; its strides over the output's dimensions
  long long base_lane;      // the stride of base's last dimension
  Operand idx[kMaxTerms];
  Operand val[kMaxTerms];
  long long* out;
  long long out_step;       // elements between consecutive outputs of one lane (2: [..., 2]; 1: planes)
  long long out_lane;       // elements between the two lanes of one output (1: [..., 2]; numel: planes)
};

struct RowsArgs {
  Operand values;           // dimensions 0-2 the rows, dimension 3 the n positions
  long long lead[3];        // sizes of the row dimensions
  long long rows;           // their product
  long long n;
  long long* out;           // int64 [rows, 2], contiguous (zeroed when split)
  int warps_per_row;        // 1, 2, 4 or 8
  long long splits;         // blocks a row (1: the row-group kernel; above 1: the split kernel, 8 warps a part)
  long long chunk;          // positions a part
};

struct ProbeArgs {
  long long lanes;          // P
  long long width;          // W candidates a lane
  int capacity;             // T slots a ring
  int chunks;               // blocks a lane
  const long long* fps;     // the ring: int64 [P, T, 2]
  long long fps_stride[3];
  const int* iters;         // int32 [P, T]
  long long iters_stride[2];
  const int* head;          // int32 [P]
  long long head_stride;
  const int* count;         // int32 [P]
  long long count_stride;
  const int* expiry;        // int32 [P]
  long long expiry_stride;
  const long long* push;    // int64 [P, 2], or null: no push
  long long push_stride[2];
  const long long* base;    // int64 [P, 2], or null: the candidates are fingerprints
  long long base_stride[2];
  const long long* cand;    // int64 [P, W, 2]
  long long cand_stride[3];
  const unsigned char* valid;  // bool [P, W], or null: write tabu
  long long valid_stride[2];
  unsigned char* out;       // bool [P, W], contiguous
  long long* out_fps;       // the pushed ring, contiguous (null without a push)
  int* out_iters;
  int* out_head;
  int* out_count;
};

struct NqMoveArgs {
  long long lanes;          // P
  long long width;          // W candidates a lane
  long long n;              // the board's columns
  long long a;              // sampled columns a lane
  const long long* fp;      // int64 [P, 2]
  long long fp_stride[2];
  const long long* cols;    // int64 [P, A]
  long long cols_stride[2];
  const long long* rows;    // int64 [P, n]
  long long rows_stride[2];
  const void* idx;          // int32 or int64 [P, W]
  long long idx_stride[2];
  int idx_wide;             // 1: int64, 0: int32
  long long* out;           // int64 [P, W, 2], contiguous
};

__device__ __forceinline__ uint32_t load_bits(const Operand& o, long long off) {
  return o.wide ? static_cast<uint32_t>(static_cast<const long long*>(o.ptr)[off])
                : static_cast<uint32_t>(static_cast<const int*>(o.ptr)[off]);
}

__device__ __forceinline__ long long offset(const Operand& o, const long long (&c)[kDims]) {
  return c[0] * o.stride[0] + c[1] * o.stride[1] + c[2] * o.stride[2] + c[3] * o.stride[3];
}

__global__ void __launch_bounds__(kThreads) fp_hash_xor_kernel(const HashArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.numel) return;
  long long c[kDims];
  long long r = i;
#pragma unroll
  for (int d = kDims - 1; d >= 0; --d) {
    c[d] = r % a.shape[d];
    r /= a.shape[d];
  }
  uint32_t h0 = 0, h1 = 0;
  if (a.has_base) {
    const long long* base = static_cast<const long long*>(a.base.ptr);
    const long long off = offset(a.base, c);
    h0 = static_cast<uint32_t>(base[off]);
    h1 = static_cast<uint32_t>(base[off + a.base_lane]);
  }
#pragma unroll
  for (int k = 0; k < kMaxTerms; ++k) {
    if (k < a.terms) {
      const uint32_t pos = load_bits(a.idx[k], offset(a.idx[k], c));
      const uint32_t v = load_bits(a.val[k], offset(a.val[k], c));
      h0 ^= mix32(v ^ mix32(pos ^ kSalt0));
      h1 ^= mix32(v ^ mix32(pos ^ kSalt1));
    }
  }
  a.out[i * a.out_step] = h0;
  a.out[i * a.out_step + a.out_lane] = h1;
}

__global__ void __launch_bounds__(kThreads) fingerprint_rows_kernel(const RowsArgs a) {
  __shared__ uint32_t part[kWarps][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wpr = a.warps_per_row;
  const long long row = static_cast<long long>(blockIdx.x) * (kWarps / wpr) + warp / wpr;
  const int span = wpr * 32;  // threads sharing the row
  uint32_t h0 = 0, h1 = 0;
  if (row < a.rows) {
    long long r = row;
    const long long c2 = r % a.lead[2];
    r /= a.lead[2];
    const long long c1 = r % a.lead[1];
    const long long c0 = r / a.lead[1];
    const long long* s = a.values.stride;
    const long long start = c0 * s[0] + c1 * s[1] + c2 * s[2];
    for (long long j = (warp % wpr) * 32 + lane; j < a.n; j += span) {
      const uint32_t v = load_bits(a.values, start + j * s[3]);
      const uint32_t pos = static_cast<uint32_t>(j);
      h0 ^= mix32(v ^ mix32(pos ^ kSalt0));
      h1 ^= mix32(v ^ mix32(pos ^ kSalt1));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    h0 ^= __shfl_xor_sync(0xffffffffu, h0, off);
    h1 ^= __shfl_xor_sync(0xffffffffu, h1, off);
  }
  if (wpr > 1) {  // uniform over the block: every thread reaches the barrier
    if (lane == 0) {
      part[warp][0] = h0;
      part[warp][1] = h1;
    }
    __syncthreads();
    if (lane == 0 && warp % wpr == 0) {
      for (int w = 1; w < wpr; ++w) {
        h0 ^= part[warp + w][0];
        h1 ^= part[warp + w][1];
      }
    }
  }
  if (row < a.rows && lane == 0 && warp % wpr == 0) {
    a.out[2 * row] = h0;
    a.out[2 * row + 1] = h1;
  }
}

__global__ void __launch_bounds__(kThreads) fingerprint_rows_split_kernel(const RowsArgs a) {
  __shared__ uint32_t part[kWarps][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = blockIdx.x / a.splits;
  const long long j0 = (blockIdx.x % a.splits) * a.chunk;
  const long long j1 = j0 + a.chunk < a.n ? j0 + a.chunk : a.n;
  long long r = row;
  const long long c2 = r % a.lead[2];
  r /= a.lead[2];
  const long long c1 = r % a.lead[1];
  const long long c0 = r / a.lead[1];
  const long long* s = a.values.stride;
  const long long start = c0 * s[0] + c1 * s[1] + c2 * s[2];
  uint32_t h0 = 0, h1 = 0;
  for (long long j = j0 + threadIdx.x; j < j1; j += kThreads) {
    const uint32_t v = load_bits(a.values, start + j * s[3]);
    const uint32_t pos = static_cast<uint32_t>(j);
    h0 ^= mix32(v ^ mix32(pos ^ kSalt0));
    h1 ^= mix32(v ^ mix32(pos ^ kSalt1));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    h0 ^= __shfl_xor_sync(0xffffffffu, h0, off);
    h1 ^= __shfl_xor_sync(0xffffffffu, h1, off);
  }
  if (lane == 0) {
    part[warp][0] = h0;
    part[warp][1] = h1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      h0 ^= part[w][0];
      h1 ^= part[w][1];
    }
    unsigned long long* out = reinterpret_cast<unsigned long long*>(a.out);
    atomicXor(out + 2 * row, static_cast<unsigned long long>(h0));
    atomicXor(out + 2 * row + 1, static_cast<unsigned long long>(h1));
  }
}

// The ring form: one block per (lane, chunk of kPer * kThreads candidates).
template <int kPer>
__global__ void __launch_bounds__(kThreads) fp_hash_probe_kernel(const ProbeArgs a) {
  __shared__ uint2 ring[kProbeTile];  // the tile's live slots, in no order
  __shared__ int n_live;
  __shared__ int first;
  const long long p = blockIdx.x / a.chunks;
  const int chunk = static_cast<int>(blockIdx.x % a.chunks);
  const int t_slots = a.capacity;
  const long long* fps = a.fps + p * a.fps_stride[0];
  const int* iters = a.iters + p * a.iters_stride[0];
  const int head = a.head[p * a.head_stride];
  int count = a.count[p * a.count_stride];
  const uint32_t expiry = static_cast<uint32_t>(a.expiry[p * a.expiry_stride]);
  const bool pushing = a.push != nullptr;
  const bool writer = pushing && chunk == 0;  // the lane's first block writes the pushed ring
  long long push0 = 0, push1 = 0;
  int slot = -1;  // the slot the push writes; -1, or a head outside [0, T): none
  if (pushing) {
    push0 = a.push[p * a.push_stride[0]];
    push1 = a.push[p * a.push_stride[0] + a.push_stride[1]];
    if (threadIdx.x == 0) first = t_slots;
    __syncthreads();
    for (int s = threadIdx.x; s < t_slots; s += kThreads) {
      const long long* f = fps + s * a.fps_stride[1];
      if (static_cast<uint32_t>(f[0]) == static_cast<uint32_t>(push0) &&
          static_cast<uint32_t>(f[a.fps_stride[2]]) == static_cast<uint32_t>(push1)) {
        atomicMin(&first, s);
      }
    }
    __syncthreads();
    const bool present = first < t_slots;
    slot = present ? first : head;
    count = static_cast<int>(static_cast<uint32_t>(count) + 1u);
    if (writer && threadIdx.x == 0) {
      int next = head;
      if (!present) {  // (head + 1) mod T in int32, the remainder taking the divisor's sign as torch's does
        next = static_cast<int>(static_cast<uint32_t>(head) + 1u) % t_slots;
        if (next < 0) next += t_slots;
      }
      a.out_head[p] = next;
      a.out_count[p] = count;
    }
  }

  // This thread's candidates, kThreads apart.
  uint32_t c0[kPer], c1[kPer];
  bool hit[kPer];
  const long long w0 = static_cast<long long>(chunk) * kPer * kThreads + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long w = w0 + k * kThreads;
    hit[k] = false;
    c0[k] = c1[k] = 0;
    if (w < a.width) {
      const long long* c = a.cand + p * a.cand_stride[0] + w * a.cand_stride[1];
      c0[k] = static_cast<uint32_t>(c[0]);
      c1[k] = static_cast<uint32_t>(c[a.cand_stride[2]]);
      if (a.base != nullptr) {
        const long long* b = a.base + p * a.base_stride[0];
        c0[k] ^= static_cast<uint32_t>(b[0]);
        c1[k] ^= static_cast<uint32_t>(b[a.base_stride[1]]);
      }
    }
  }

  for (int t0 = 0; t0 < t_slots; t0 += kProbeTile) {
    if (threadIdx.x == 0) n_live = 0;
    __syncthreads();
    const int t1 = t0 + kProbeTile < t_slots ? t0 + kProbeTile : t_slots;
    for (int s = t0 + threadIdx.x; s < t1; s += kThreads) {
      const long long* f = fps + s * a.fps_stride[1];
      long long f0 = f[0], f1 = f[a.fps_stride[2]];
      int it = iters[s * a.iters_stride[1]];
      if (s == slot) {
        f0 = push0;
        f1 = push1;
        it = count;
      }
      if (writer) {
        a.out_fps[(p * t_slots + s) * 2] = f0;
        a.out_fps[(p * t_slots + s) * 2 + 1] = f1;
        a.out_iters[p * t_slots + s] = it;
      }
      if (static_cast<int>(static_cast<uint32_t>(it) + expiry) >= count) {
        ring[atomicAdd(&n_live, 1)] = make_uint2(static_cast<uint32_t>(f0), static_cast<uint32_t>(f1));
      }
    }
    __syncthreads();
    const int live = n_live;
    for (int j = 0; j < live; ++j) {
      const uint2 e = ring[j];  // every thread reads the same word: a broadcast
#pragma unroll
      for (int k = 0; k < kPer; ++k) hit[k] |= (e.x == c0[k]) & (e.y == c1[k]);
    }
    __syncthreads();  // the next tile overwrites ring and n_live
  }

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long w = w0 + k * kThreads;
    if (w < a.width) {
      unsigned char o = hit[k];
      if (a.valid != nullptr) o = a.valid[p * a.valid_stride[0] + w * a.valid_stride[1]] != 0 && !hit[k];
      a.out[p * a.width + w] = o;
    }
  }
}

__global__ void __launch_bounds__(kThreads) fp_nq_move_kernel(const NqMoveArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.lanes * a.width) return;
  const long long p = i / a.width, w = i - p * a.width;
  const long long at = p * a.idx_stride[0] + w * a.idx_stride[1];
  const long long flat = a.idx_wide ? static_cast<const long long*>(a.idx)[at]
                                    : static_cast<long long>(static_cast<const int*>(a.idx)[at]);
  const long long j = flat / a.n;
  const long long col = a.cols[p * a.cols_stride[0] + j * a.cols_stride[1]];
  const uint32_t pos = static_cast<uint32_t>(col);
  const uint32_t old = static_cast<uint32_t>(a.rows[p * a.rows_stride[0] + col * a.rows_stride[1]]);
  const uint32_t nw = static_cast<uint32_t>(flat - j * a.n);
  const long long* f = a.fp + p * a.fp_stride[0];
  uint32_t h0 = static_cast<uint32_t>(f[0]), h1 = static_cast<uint32_t>(f[a.fp_stride[1]]);
  h0 ^= mix32(old ^ mix32(pos ^ kSalt0)) ^ mix32(nw ^ mix32(pos ^ kSalt0));
  h1 ^= mix32(old ^ mix32(pos ^ kSalt1)) ^ mix32(nw ^ mix32(pos ^ kSalt1));
  a.out[2 * i] = h0;
  a.out[2 * i + 1] = h1;
}

Operand read_operand(const long long* p) {
  Operand o;
  o.ptr = reinterpret_cast<const void*>(p[0]);
  for (int d = 0; d < kDims; ++d) o.stride[d] = p[1 + d];
  o.wide = static_cast<int>(p[5]);
  return o;
}

bool valid_operand(const Operand& o) { return o.ptr != nullptr && (o.wide == 0 || o.wide == 1); }

}  // namespace

// K2a.  plan[0:4] the output's shape (leading 1s), [4] its element count, [5]
// the terms K (1-4), [6] the output pointer (int64), [7] out_step, [8] out_lane,
// [9] base's lane stride, [10:16] the base operand (pointer 0: no base), then for
// each k < 4 the position operand idx_k at [16 + 12k] and the value operand
// val_k at [22 + 12k] (unused terms: zeros).  An operand is (pointer, 4 element
// strides over the output's dimensions, width).
extern "C" int fp_hash_xor_launch(const long long* plan, void* stream) {
  HashArgs a;
  long long numel = 1;
  for (int d = 0; d < kDims; ++d) {
    a.shape[d] = plan[d];
    if (a.shape[d] < 1) return static_cast<int>(cudaErrorInvalidValue);
    numel *= a.shape[d];
  }
  a.numel = plan[4];
  a.terms = static_cast<int>(plan[5]);
  a.out = reinterpret_cast<long long*>(plan[6]);
  a.out_step = plan[7];
  a.out_lane = plan[8];
  a.base_lane = plan[9];
  a.base = read_operand(plan + 10);
  a.has_base = a.base.ptr != nullptr;
  if (numel != a.numel || a.terms < 1 || a.terms > kMaxTerms || a.out == nullptr ||
      (a.has_base && a.base.wide != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < kMaxTerms; ++k) {
    a.idx[k] = read_operand(plan + 16 + 2 * kOperandLen * k);
    a.val[k] = read_operand(plan + 16 + 2 * kOperandLen * k + kOperandLen);
    if (k < a.terms && !(valid_operand(a.idx[k]) && valid_operand(a.val[k]))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const long long blocks = (numel + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fp_hash_xor_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2b.  plan[0:6] the values operand (pointer, 4 element strides, width), [6:9]
// the row dimensions' sizes, [9] the rows, [10] n, [11] the output pointer
// (int64 [rows, 2], contiguous; zeroed when split), [12] warps per row (1, 2, 4
// or 8), [13] the grid, [14] the parts a row (splits), [15] the positions a
// part (chunk).  Splits 1: ceil(rows / (8 / warps per row)) blocks of 256
// threads, the row-group kernel.  Splits above 1: 8 warps a row, rows x splits
// blocks, each part of chunk positions, none empty, the split kernel.
extern "C" int fingerprint_rows_launch(const long long* plan, void* stream) {
  RowsArgs a;
  a.values = read_operand(plan);
  for (int d = 0; d < 3; ++d) a.lead[d] = plan[6 + d];
  a.rows = plan[9];
  a.n = plan[10];
  a.out = reinterpret_cast<long long*>(plan[11]);
  a.warps_per_row = static_cast<int>(plan[12]);
  const long long grid = plan[13];
  a.splits = plan[14];
  a.chunk = plan[15];
  const int wpr = a.warps_per_row;
  if (!valid_operand(a.values) || a.out == nullptr || a.rows < 1 || a.n < 1 || a.lead[0] < 1 || a.lead[1] < 1 ||
      a.lead[2] < 1 || a.lead[0] * a.lead[1] * a.lead[2] != a.rows || !(wpr == 1 || wpr == 2 || wpr == 4 || wpr == 8) ||
      a.splits < 1 || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.splits == 1) {
    if (grid != (a.rows + kWarps / wpr - 1) / (kWarps / wpr)) return static_cast<int>(cudaErrorInvalidValue);
    fingerprint_rows_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(a);
  } else {
    if (wpr != kWarps || a.chunk < 1 || (a.splits - 1) * a.chunk >= a.n || a.splits * a.chunk < a.n ||
        grid != a.rows * a.splits) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    fingerprint_rows_split_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2a's ring form.  plan[0] P, [1] W, [2] T, [3] blocks a lane (chunks), [4]
// candidates a thread (1, 2 or 4); then (pointer, element strides): [5:9] fps
// (p, t, word), [9:12] iters (p, t), [12:14] head, [14:16] count, [16:18]
// expiry, [18:21] push (p, word; pointer 0: no push), [21:24] base (p, word;
// pointer 0: none), [24:28] the candidates (p, w, word), [28:31] valid (p, w;
// pointer 0: write tabu); [31] the output (bool [P, W]), [32:36] the pushed
// ring's fps, iters, head and count (contiguous; 0 without a push).  The grid
// is P x chunks blocks of 256 threads, chunks = ceil(W / (256 x per thread)),
// at least 1.
extern "C" int fp_hash_probe_launch(const long long* plan, void* stream) {
  ProbeArgs a;
  a.lanes = plan[0];
  a.width = plan[1];
  a.capacity = static_cast<int>(plan[2]);
  a.chunks = static_cast<int>(plan[3]);
  const int per = static_cast<int>(plan[4]);
  a.fps = reinterpret_cast<const long long*>(plan[5]);
  for (int d = 0; d < 3; ++d) a.fps_stride[d] = plan[6 + d];
  a.iters = reinterpret_cast<const int*>(plan[9]);
  a.iters_stride[0] = plan[10];
  a.iters_stride[1] = plan[11];
  a.head = reinterpret_cast<const int*>(plan[12]);
  a.head_stride = plan[13];
  a.count = reinterpret_cast<const int*>(plan[14]);
  a.count_stride = plan[15];
  a.expiry = reinterpret_cast<const int*>(plan[16]);
  a.expiry_stride = plan[17];
  a.push = reinterpret_cast<const long long*>(plan[18]);
  a.push_stride[0] = plan[19];
  a.push_stride[1] = plan[20];
  a.base = reinterpret_cast<const long long*>(plan[21]);
  a.base_stride[0] = plan[22];
  a.base_stride[1] = plan[23];
  a.cand = reinterpret_cast<const long long*>(plan[24]);
  for (int d = 0; d < 3; ++d) a.cand_stride[d] = plan[25 + d];
  a.valid = reinterpret_cast<const unsigned char*>(plan[28]);
  a.valid_stride[0] = plan[29];
  a.valid_stride[1] = plan[30];
  a.out = reinterpret_cast<unsigned char*>(plan[31]);
  a.out_fps = reinterpret_cast<long long*>(plan[32]);
  a.out_iters = reinterpret_cast<int*>(plan[33]);
  a.out_head = reinterpret_cast<int*>(plan[34]);
  a.out_count = reinterpret_cast<int*>(plan[35]);
  const long long per_block = static_cast<long long>(per) * kThreads;
  const long long chunks = a.width > per_block ? (a.width + per_block - 1) / per_block : 1;
  const bool ring_out = a.out_fps != nullptr && a.out_iters != nullptr && a.out_head != nullptr &&
                        a.out_count != nullptr;
  if (a.lanes < 1 || a.width < 0 || plan[2] < 1 || plan[2] > 0x7fffffffLL || !(per == 1 || per == 2 || per == 4) ||
      a.chunks != chunks || a.lanes * chunks > 0x7fffffffLL || a.fps == nullptr || a.iters == nullptr ||
      a.head == nullptr || a.count == nullptr || a.expiry == nullptr || (a.width > 0 && a.cand == nullptr) ||
      (a.width > 0 && a.out == nullptr) || (a.push != nullptr) != ring_out ||
      (a.push == nullptr && a.width == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(a.lanes * chunks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per == 1) {
    fp_hash_probe_kernel<1><<<grid, kThreads, 0, s>>>(a);
  } else if (per == 2) {
    fp_hash_probe_kernel<2><<<grid, kThreads, 0, s>>>(a);
  } else {
    fp_hash_probe_kernel<4><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7.  plan[0] P, [1] W, [2] n, [3] A, then (pointer, 2 element strides):
// [4:7] fp (p, word), [7:10] cols (p, sample), [10:13] rows (p, column),
// [13:16] idx (p, candidate); [16] idx's width (1: int64, 0: int32), [17] the
// output (int64 [P, W, 2], contiguous).  ceil(P·W / 256) blocks of 256 threads.
extern "C" int fp_nq_move_launch(const long long* plan, void* stream) {
  NqMoveArgs a;
  a.lanes = plan[0];
  a.width = plan[1];
  a.n = plan[2];
  a.a = plan[3];
  a.fp = reinterpret_cast<const long long*>(plan[4]);
  a.fp_stride[0] = plan[5];
  a.fp_stride[1] = plan[6];
  a.cols = reinterpret_cast<const long long*>(plan[7]);
  a.cols_stride[0] = plan[8];
  a.cols_stride[1] = plan[9];
  a.rows = reinterpret_cast<const long long*>(plan[10]);
  a.rows_stride[0] = plan[11];
  a.rows_stride[1] = plan[12];
  a.idx = reinterpret_cast<const void*>(plan[13]);
  a.idx_stride[0] = plan[14];
  a.idx_stride[1] = plan[15];
  a.idx_wide = static_cast<int>(plan[16]);
  a.out = reinterpret_cast<long long*>(plan[17]);
  const long long total = a.lanes * a.width;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (a.lanes < 1 || a.width < 1 || a.n < 1 || a.a < 1 || a.fp == nullptr || a.cols == nullptr ||
      a.rows == nullptr || a.idx == nullptr || a.out == nullptr || !(a.idx_wide == 0 || a.idx_wide == 1) ||
      blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fp_nq_move_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

static_assert(kHashPlanLen == 64, "ops/fingerprint.py writes 64 entries for K2a");
static_assert(kRowsPlanLen == 16, "ops/fingerprint.py writes 16 entries for K2b");
static_assert(kProbePlanLen == 36, "ops/fingerprint.py writes 36 entries for K2a's ring form");
static_assert(kNqMovePlanLen == 18, "ops/fingerprint.py writes 18 entries for K7");
