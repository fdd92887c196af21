// The fingerprint hash on Hopper (sm_90a): K2, `fp_hash_xor` (K2a) and `fingerprint_rows` (K2b).
//
// Replaces no Pallas kernel.  It stands for the fusions that XLA makes of the
// JAX package's fingerprint arithmetic (constraint_solver_tpu/ops/fingerprint.py:30-95:
// `_mix32`, `position_hash_planes`, `_xor_reduce`, `fingerprint_i32`,
// `fp_update`) wherever the jitted descent uses it: each use is one pass.  For
// a position i and a value v, in uint32 and for each of the two lane salts,
//
//   h(i, v) = mix32(v ^ mix32(i ^ salt)),   mix32 = murmur3's fmix32 finalizer
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
//   shared memory.
//
// Inputs are taken modulo 2^32 (their low 32 bits, so a negative int32 hashes as
// its bit pattern, as the JAX package's astype(uint32) does), and outputs are
// int64 holding the uint32 value, the port's representation of a fingerprint
// (ops/fingerprint.py).  uint32 multiplication wraps exactly as the plain
// version's masked int64 product does, and XOR is associative and commutative,
// so both kernels equal the plain version bit for bit for any input.
//
// What bounds them on this card: neither bytes nor operations.  The solvers give
// K2a a few thousand to half a million outputs (16 bytes each) and K2b rows of
// 365 to 16,384 positions; the largest call, the roster's dense block of [64,
// 365, 20], moves 7.6 MB (2.3 us at 3.35 TB/s) and does 38 integer operations
// a term and output (36 M, 0.5 us at 67 T/s).  Most calls move a few KB, so
// what they cost is a launch: the design's aim is one launch for each use,
// in place of the plain version's 34-96 eager int64 passes, and nothing copied
// to get there.
//
// Each C entry takes its whole plan as one array of int64 (the layouts below,
// written by ops/fingerprint.py `_hash_plan` / `_rows_plan` with the pointers
// appended), checks it, launches on `stream` without synchronising, and returns
// cudaGetLastError().  The kernels take their arguments as one struct by value,
// so a CUDA graph captures the launch with its arguments.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSalt0 = 0x9E3779B9u;  // the JAX package's two lane salts
constexpr uint32_t kSalt1 = 0x85EBCA77u;
constexpr int kDims = 4;                  // dimensions of an operand or of K2a's output
constexpr int kMaxTerms = 4;              // (position, value) terms of K2a
constexpr int kThreads = 256;             // threads of a block, both kernels
constexpr int kWarps = kThreads / 32;

// The plans' layouts (int64 entries), as ops/fingerprint.py writes them.
constexpr int kOperandLen = 6;            // pointer, 4 strides, width (1: int64, 0: int32)
constexpr int kHashPlanLen = 16 + 2 * kOperandLen * kMaxTerms;  // 64
constexpr int kRowsPlanLen = 14;

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
  long long* out;           // int64 [rows, 2], contiguous
  int warps_per_row;        // 1, 2, 4 or 8
};

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

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
// (int64 [rows, 2], contiguous), [12] warps per row (1, 2, 4 or 8), [13] the
// grid: ceil(rows / (8 / warps per row)) blocks of 256 threads.
extern "C" int fingerprint_rows_launch(const long long* plan, void* stream) {
  RowsArgs a;
  a.values = read_operand(plan);
  for (int d = 0; d < 3; ++d) a.lead[d] = plan[6 + d];
  a.rows = plan[9];
  a.n = plan[10];
  a.out = reinterpret_cast<long long*>(plan[11]);
  a.warps_per_row = static_cast<int>(plan[12]);
  const long long grid = plan[13];
  const int wpr = a.warps_per_row;
  if (!valid_operand(a.values) || a.out == nullptr || a.rows < 1 || a.n < 1 || a.lead[0] < 1 || a.lead[1] < 1 ||
      a.lead[2] < 1 || a.lead[0] * a.lead[1] * a.lead[2] != a.rows || !(wpr == 1 || wpr == 2 || wpr == 4 || wpr == 8) ||
      grid != (a.rows + kWarps / wpr - 1) / (kWarps / wpr) || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fingerprint_rows_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

static_assert(kHashPlanLen == 64, "ops/fingerprint.py writes 64 entries for K2a");
static_assert(kRowsPlanLen == 14, "ops/fingerprint.py writes 14 entries for K2b");
