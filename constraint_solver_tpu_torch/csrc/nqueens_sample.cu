// The N-Queens column sample and the block's inputs on Hopper (sm_90a): K6, `nqueens_sample`.
//
// Replaces no Pallas kernel.  It stands for the fusion that XLA makes of the
// JAX package's Gumbel top-k column sample and of the gathers that feed the
// block (constraint_solver_tpu/models/nqueens.py:196-238 `neighborhood`, around
// `jax.lax.top_k`, with `_take_1d` at :106-110), which the port ran as a stable
// descending `torch.sort` of the whole [P, n] and about 28 eager launches.  For
// each lane p, with the key of column j
//
//   k_j = (cs_j > 0 ? table[(long)cs_j] : -inf) + gumbel_j     (one float32 add)
//
// it writes the A columns of the largest keys, in descending key order and,
// among equal keys (the -inf tail of unconflicted columns included), lower
// column first: the stable sort's order, and lax.top_k's.  Then, for each
// sampled column c_i: cols[i] = c_i (int64), c32[i] = c_i and r32[i] =
// rows[c_i] (int32, B1's inputs), removed[i] = ((rc[r] - 1) + (dc[r - c + n -
// 1] - 1)) + (ac[r + c] - 1) in that order, col_valid[i] = i < min(num_cols,
// n_conflicted); and n_valid = that count, clamped to [0, A], times n.  Every
// output equals the plain version's (ops/nqueens_sample.py) bit for bit: the
// key is the same single add, the order a total order on (key, column), the
// counters small integers.
//
// The algorithm, one block of 256, 512 or 1024 threads a lane:
// - each key becomes an order-preserving uint32 (-0.0 as +0.0, so that the
//   two tie as a float compare does), kept in shared memory, or in a global
//   scratch where n keys do not fit; the key pass also counts the first
//   digit's histogram and the keys of -inf (every unconflicted column: one
//   value, counted once and added to its bin as one count);
// - radix select of the A-th largest key, 8 bits a pass from the top: a
//   256-bin histogram of the keys that match the prefix found so far, then
//   every warp searches it alike for the bin where the count from the top
//   reaches what is still wanted, so a pass costs one barrier (three
//   histograms in turn; a word of padding every 8 bins keeps the search's
//   reads free of bank conflicts).  It stops once a bin holds exactly what is
//   wanted, or holds only the -inf keys (a board with fewer conflicted
//   columns than A: one pass);
// - the survivors: every key above the prefix, then the first `need` keys equal
//   to it in column order: each warp walks its own run of columns in steps of
//   32 and counts them by ballots, a shuffle scan over the warps' counts gives
//   each its slots, and each survivor is written as one 64-bit (key, ~column);
// - each survivor placed at its rank among the A (A at most the threads and
//   256: the cells' 50 and 64), the thread loading its row while it counts;
//   above that a bitonic sort, descending, of the survivors padded to a power
//   of two, in shared memory or in a global scratch; then the outputs.
//
// What bounds it on this card: bytes.  It must read cs and gumbel once (8
// bytes a column) and A entries of rows, rc, dc and ac, and write 21 bytes a
// sampled column: about 2.6 MB at (256, 1000, 50), 0.77 us at 3.35 TB/s.
// What a block waits on is latency: two dependent reads of device memory for
// the keys (cs, then the table), a few barriers, two for each survivor's row
// and counters.  Its time by phase is in PERF.md.  At (16, 16384, 64)
// one block a lane keeps 16 of the 132 SMs busy, and the key pass there is
// held by what 16 SMs read; a lane spread over a thread-block cluster is not
// done.
//
// The C entry takes its whole plan as one int64 array (written by
// ops/nqueens_sample.py `_plan_values`), checks it, launches on `stream`
// without synchronising, and returns cudaGetLastError().  The kernel takes its
// arguments as one struct by value, so a CUDA graph captures the launch whole.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 256;                 // one radix digit: 8 bits
constexpr int kHistLen = kBins + kBins / 8;  // a histogram with a word of padding every 8 bins (`at`)
constexpr uint32_t kNegInfKey = 0x007FFFFFu;  // the ordered key of -inf
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPlanLen = 27;               // ops/nqueens_sample.py PLAN_LEN
constexpr int kRankMax = 256;              // the most survivors placed by rank (ops/nqueens_sample.py RANK_MAX)
constexpr int kUnroll = 4;                 // columns a thread loads at once in the key pass
constexpr int kSmemMax = 232448 - 4096;    // dynamic shared memory a block may take (227 KB less the static)

struct Args {
  int lanes, n, a, a_pad, threads, per;    // per: columns a thread's run holds (ceil(n / threads))
  int smem;                                // dynamic shared memory bytes
  int keys_shared, cands_shared;           // where the keys and the survivors live
  int rank_sort;                           // 1: each survivor placed by its rank (A <= threads); 0: bitonic
  const float* cs;                         // [P, n]
  const float* table;                      // the log weights, read at cs
  const float* gumbel;                     // [P, n]
  const long long* num_cols;               // [P]
  const long long* n_conflicted;           // [P]
  const long long* rows;                   // [P, n]
  const float* rc;                         // [P, n]
  const float* dc;                         // [P, 2n - 1]
  const float* ac;                         // [P, 2n - 1]
  long long* cols;                         // [P, A] out
  int* c32;                                // [P, A] out
  int* r32;                                // [P, A] out
  float* removed;                          // [P, A] out
  unsigned char* col_valid;                // [P, A] out
  long long* n_valid;                      // [P] out
  uint32_t* key_scratch;                   // [P, n], where the keys are not shared
  unsigned long long* cand_scratch;        // [P, a_pad], where the survivors are not shared
};

// An order-preserving uint32 of a float: a larger float, a larger key.
__device__ __forceinline__ uint32_t order_key(float k) {
  uint32_t b = __float_as_uint(k);
  if (k == 0.0f) b = 0u;  // -0.0 ties +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Sampled column j on row r, the o-th output of the block.
__device__ __forceinline__ void write_sample(const Args& g, long long o, int j, long long r, const float* rc,
                                             const float* dc, const float* ac, bool valid) {
  const int n = g.n;
  g.cols[o] = j;
  g.c32[o] = j;
  g.r32[o] = static_cast<int>(r);
  const float t = __fadd_rn(__fsub_rn(rc[r], 1.0f), __fsub_rn(dc[r - j + n - 1], 1.0f));
  g.removed[o] = __fadd_rn(t, __fsub_rn(ac[r + j], 1.0f));
  g.col_valid[o] = valid;
}

// Bin b's word in a histogram: one word of padding every 8 bins, so that a
// warp's search (lane l the bins 255 - 8l down to 248 - 8l) reads with no bank conflict.
__device__ __forceinline__ int at(int b) { return b + (b >> 3); }

// (key, column) as one 64-bit value: larger key first, then lower column.
__device__ __forceinline__ unsigned long long survivor(uint32_t key, int j) {
  return (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned long long>(kFull - static_cast<uint32_t>(j));
}

// This warp's search of a pass's histogram `h` (every warp searches it alike,
// so no barrier hands the result on): the bin from the top at which the count
// reaches `need`, the -inf keys counted as `n_inf` in their bin where they
// match the prefix.  Updates prefix, mask and need; returns whether the select
// is done: that bin's keys are all taken, or they are all -inf (one value: the
// prefix becomes -inf's key whole, as on a board with fewer conflicted columns
// than A).
__device__ __forceinline__ bool search(const int* h, int shift, int n_inf, uint32_t& prefix, uint32_t& mask,
                                       int& need) {
  const int lane = threadIdx.x % 32;
  const bool inf_here = (kNegInfKey & mask) == prefix;
  const int inf_bin = static_cast<int>((kNegInfKey >> shift) & 0xFFu);
  int cnt[8], sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // lane l holds the bins 255 - 8l down to 248 - 8l
    const int b = 255 - 8 * lane - k;
    cnt[k] = h[at(b)] + (inf_here && b == inf_bin ? n_inf : 0);
    sum += cnt[k];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  int run = incl - sum, bin = 0, rem = 0, done = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (run < need && need <= run + cnt[k]) {
      bin = 255 - 8 * lane - k;
      rem = need - run;
      done = cnt[k] == need - run ? 1 : (inf_here && bin == inf_bin && cnt[k] == n_inf ? 2 : 0);
    }
    run += cnt[k];
  }
  const int src = __ffs(__ballot_sync(kFull, rem > 0)) - 1;  // exactly one lane
  bin = __shfl_sync(kFull, bin, src);
  need = __shfl_sync(kFull, rem, src);
  done = __shfl_sync(kFull, done, src);
  prefix |= static_cast<uint32_t>(bin) << shift;
  mask |= 0xFFu << shift;
  if (done == 2) {  // the bin holds the -inf keys and nothing else
    prefix = kNegInfKey;
    mask = kFull;
  }
  return done != 0;
}

__global__ void __launch_bounds__(1024) nqueens_sample_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int hist[3][kHistLen];  // a pass's histogram, three in turn: one barrier a pass
  __shared__ unsigned long long warp_sum[32];
  __shared__ int s_inf;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = g.threads / 32;
  const long long p = blockIdx.x;
  const int n = g.n, a = g.a, t = g.threads;
  unsigned long long* cands = g.cands_shared ? reinterpret_cast<unsigned long long*>(smem)
                                             : g.cand_scratch + p * g.a_pad;
  uint32_t* keys = g.keys_shared
                       ? reinterpret_cast<uint32_t*>(smem + (g.cands_shared ? 8 * g.a_pad : 0))
                       : g.key_scratch + p * n;
  for (int b = tid; b < 2 * kHistLen; b += t) (&hist[0][0])[b] = 0;
  if (tid == 0) s_inf = 0;
  __syncthreads();

  // The keys, how many are -inf, and the first pass's histogram (the top 8 bits).
  const float* __restrict__ cs = g.cs + p * n;
  const float* __restrict__ gumbel = g.gumbel + p * n;
  const float* __restrict__ table = g.table;
  int inf = 0;
  for (int j0 = tid; j0 < n; j0 += kUnroll * t) {
    float x[kUnroll], gm[kUnroll], lg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // every load of the group in flight at once
      const int j = j0 + u * t;
      x[u] = j < n ? cs[j] : 0.0f;
      gm[u] = j < n ? gumbel[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) lg[u] = x[u] > 0.0f ? table[static_cast<long long>(x[u])] : -__int_as_float(0x7F800000);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * t;
      if (j < n) {
        const uint32_t key = order_key(__fadd_rn(lg[u], gm[u]));
        keys[j] = key;
        if (key == kNegInfKey) {
          ++inf;
        } else {
          atomicAdd(&hist[0][at(static_cast<int>(key >> 24))], 1);
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) inf += __shfl_xor_sync(kFull, inf, off);
  if (lane == 0 && inf) atomicAdd(&s_inf, inf);
  __syncthreads();

  // Radix select: after it the survivors are the keys whose masked bits are
  // above `prefix`, and the first `need` whose masked bits equal it.
  const int n_inf = s_inf;
  uint32_t prefix = 0, mask = 0;
  int need = a;
  bool all = search(hist[0], 24, n_inf, prefix, mask, need);
  for (int pass = 1, shift = 16; !all && shift >= 0; ++pass, shift -= 8) {
    int* h = hist[pass % 3];
    for (int b = tid; b < kHistLen; b += t) hist[(pass + 1) % 3][b] = 0;  // the next pass's, last read two passes ago
    for (int j0 = tid; j0 < n; j0 += kUnroll * t) {
      uint32_t u[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) u[k] = j0 + k * t < n ? keys[j0 + k * t] : kNegInfKey;  // loads first
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (u[k] != kNegInfKey && (u[k] & mask) == prefix) atomicAdd(&h[at(static_cast<int>((u[k] >> shift) & 0xFFu))], 1);
      }
    }
    __syncthreads();
    all = search(h, shift, n_inf, prefix, mask, need);
  }

  // The survivors, in column order: warp w takes the columns [w·32·per,
  // (w+1)·32·per) in steps of 32 (lane l the step's l-th column, so the
  // keys are read with no bank conflict), counts them by ballots, and the
  // warps' counts are scanned through shared memory.
  const int base = warp * 32 * g.per + lane;
  const unsigned lower = (1u << lane) - 1u;  // the lanes before this one
  unsigned above = 0, equal = 0;
  for (int s = 0; s < g.per; ++s) {
    const int j = base + 32 * s;
    const uint32_t m = j < n ? keys[j] & mask : 0u;
    above += __popc(__ballot_sync(kFull, j < n && m > prefix));
    equal += __popc(__ballot_sync(kFull, j < n && m == prefix));
  }
  if (lane == 0) warp_sum[warp] = (static_cast<unsigned long long>(above) << 32) | equal;
  __syncthreads();
  unsigned long long before = lane < warp ? warp_sum[lane] : 0ull;  // every warp adds up the warps before it
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) before += __shfl_xor_sync(kFull, before, off);
  int slot_above = static_cast<int>(before >> 32);
  int rank_equal = static_cast<int>(before & 0xFFFFFFFFull);
  const int n_above = a - need;
  for (int s = 0; s < g.per; ++s) {
    const int j = base + 32 * s;
    const uint32_t u = j < n ? keys[j] : 0u;
    const uint32_t m = u & mask;
    const unsigned ab = __ballot_sync(kFull, j < n && m > prefix);
    const unsigned eq = __ballot_sync(kFull, j < n && m == prefix);
    if (j < n && m > prefix) {
      cands[slot_above + __popc(ab & lower)] = survivor(u, j);
    } else if (j < n && m == prefix) {
      const int r = rank_equal + __popc(eq & lower);
      if (r < need) cands[n_above + r] = survivor(u, j);
    }
    slot_above += __popc(ab);
    rank_equal += __popc(eq);
  }
  long long valid = g.num_cols[p] < g.n_conflicted[p] ? g.num_cols[p] : g.n_conflicted[p];
  valid = valid < 0 ? 0 : (valid > a ? a : valid);
  const long long* rows = g.rows + p * n;
  const float* rc = g.rc + p * n;
  const float* dc = g.dc + p * (2LL * n - 1);
  const float* ac = g.ac + p * (2LL * n - 1);
  if (g.rank_sort) {
    // A survivors, A at most the block's threads: thread i puts survivor i at
    // its rank among them, loading its row while it counts.
    __syncthreads();
    if (tid < a) {
      const unsigned long long v = cands[tid];
      const int j = static_cast<int>(kFull - static_cast<uint32_t>(v));
      const long long r = rows[j];
      int rank = 0;
#pragma unroll 8
      for (int k = 0; k < a; ++k) rank += cands[k] > v;
      write_sample(g, p * a + rank, j, r, rc, dc, ac, rank < valid);
    }
  } else {
    for (int i = a + tid; i < g.a_pad; i += t) cands[i] = 0ull;  // below every survivor
    __syncthreads();
    for (int size = 2; size <= g.a_pad; size <<= 1) {  // bitonic sort, descending
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < g.a_pad; i += t) {
          const int k = i ^ stride;
          if (k > i) {
            const unsigned long long x = cands[i], y = cands[k];
            if ((i & size) == 0 ? x < y : x > y) {
              cands[i] = y;
              cands[k] = x;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < a; i += t) {
      const int j = static_cast<int>(kFull - static_cast<uint32_t>(cands[i]));
      write_sample(g, p * a + i, j, rows[j], rc, dc, ac, i < valid);
    }
  }
  if (tid == 0) g.n_valid[p] = valid * n;
}

}  // namespace

// plan[0] P, [1] n, [2] A, [3] A padded to a power of two, [4] threads (256,
// 512 or 1024), [5] columns a thread's run (ceil(n / threads)), [6] dynamic
// shared memory bytes, [7] keys in shared memory (1) or in the key scratch,
// [8] the survivors in shared memory (1) or in the survivor scratch, [9] the
// survivors placed by rank (1; A at most the threads and kRankMax) or sorted
// by a bitonic sort; then the pointers: [10] cs, [11] table, [12] gumbel, [13]
// num_cols, [14] n_conflicted, [15] rows, [16] rc, [17] dc, [18] ac, [19]
// cols, [20] c32, [21] r32, [22] removed, [23] col_valid, [24] n_valid, [25]
// the key scratch (uint32 [P, n]; 0 when the keys are shared), [26] the
// survivor scratch (uint64 [P, A padded]; 0 when shared).  The grid is P blocks.
extern "C" int nqueens_sample_launch(const long long* plan, void* stream) {
  Args g;
  const long long lanes = plan[0], n = plan[1], a = plan[2], a_pad = plan[3];
  g.threads = static_cast<int>(plan[4]);
  g.per = static_cast<int>(plan[5]);
  g.smem = static_cast<int>(plan[6]);
  g.keys_shared = static_cast<int>(plan[7]);
  g.cands_shared = static_cast<int>(plan[8]);
  g.rank_sort = static_cast<int>(plan[9]);
  g.cs = reinterpret_cast<const float*>(plan[10]);
  g.table = reinterpret_cast<const float*>(plan[11]);
  g.gumbel = reinterpret_cast<const float*>(plan[12]);
  g.num_cols = reinterpret_cast<const long long*>(plan[13]);
  g.n_conflicted = reinterpret_cast<const long long*>(plan[14]);
  g.rows = reinterpret_cast<const long long*>(plan[15]);
  g.rc = reinterpret_cast<const float*>(plan[16]);
  g.dc = reinterpret_cast<const float*>(plan[17]);
  g.ac = reinterpret_cast<const float*>(plan[18]);
  g.cols = reinterpret_cast<long long*>(plan[19]);
  g.c32 = reinterpret_cast<int*>(plan[20]);
  g.r32 = reinterpret_cast<int*>(plan[21]);
  g.removed = reinterpret_cast<float*>(plan[22]);
  g.col_valid = reinterpret_cast<unsigned char*>(plan[23]);
  g.n_valid = reinterpret_cast<long long*>(plan[24]);
  g.key_scratch = reinterpret_cast<uint32_t*>(plan[25]);
  g.cand_scratch = reinterpret_cast<unsigned long long*>(plan[26]);
  const int t = g.threads;
  const long long smem = (g.cands_shared ? 8 * a_pad : 0) + (g.keys_shared ? 4 * n : 0);
  const void* in[] = {g.cs, g.table, g.gumbel, g.num_cols, g.n_conflicted, g.rows, g.rc, g.dc, g.ac,
                      g.cols, g.c32, g.r32, g.removed, g.col_valid, g.n_valid};
  bool ok = lanes >= 1 && lanes <= 0x7FFFFFFFLL && n >= 1 && n <= (1LL << 24) && a >= 1 && a <= n &&
            a_pad >= a && (a_pad < 2 * a || a_pad == 1) && (a_pad & (a_pad - 1)) == 0 &&
            (t == 256 || t == 512 || t == 1024) && g.per == (n + t - 1) / t && smem == g.smem &&
            smem <= kSmemMax && (g.keys_shared || g.key_scratch != nullptr) &&
            (g.cands_shared || g.cand_scratch != nullptr) &&
            (g.rank_sort == 0 || (g.rank_sort == 1 && a <= t && a <= kRankMax));
  for (const void* ptr : in) ok = ok && ptr != nullptr;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  g.lanes = static_cast<int>(lanes);
  g.n = static_cast<int>(n);
  g.a = static_cast<int>(a);
  g.a_pad = static_cast<int>(a_pad);
  if (g.smem > 48 * 1024) {
    static int allowed[64] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 64 || allowed[device] < kSmemMax) {
      err = cudaFuncSetAttribute(nqueens_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (device < 64) allowed[device] = kSmemMax;
    }
  }
  nqueens_sample_kernel<<<static_cast<unsigned>(lanes), t, g.smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

static_assert(kPlanLen == 27, "ops/nqueens_sample.py writes 27 entries");
