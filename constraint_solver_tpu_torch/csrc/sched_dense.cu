// K5, the roster's dense neighborhood on Hopper (sm_90a): `sched_dense_kernel`,
// one launch that writes every candidate of the dense proposer's neighborhood:
// the ChangeDay block (K5a), the random swaps (K5c) and the swap diagonals (K5b).
//
// Replaces no Pallas kernel.  It stands for the fusions that XLA makes of the
// JAX package's dense roster neighborhood inside the jitted descent
// (constraint_solver_tpu/models/scheduling.py:594-884 `neighborhood_dense`, with
// `exact_move_deltas` :454-555 for the random swaps), which eager PyTorch runs
// as about 770 kernels a call (ops/sched_dense.py `sched_dense_ref`).
//
// For one lane, an assignment a[D] of employees 0..E-1 to days, its current
// score (hard, soft) and the draws, the neighborhood has W = D·E + R + O·D
// candidates, written straight into their final places, in this order:
//
// - [0, D·E): ChangeDay(d, e), index d·E + e.  Its delta is exact: H1 the
//   holiday row, H2 the two adjacent pairs, H3 the four 9-day weekend windows
//   that hold day d at position 0, 1, 7 or 8, H4 / S1 the 14- and 7-day
//   windows whose count of e reaches the threshold (+1) or of a[d] leaves it
//   (-1), S2 / S3 / S4 the weekday row, totals and weekend totals with one
//   day moved from a[d] to e, each a min or max over the employees present
//   with one entry changed; the identity move e == a[d] has delta 0.
// - [D·E, D·E + R): R random swaps of days d1 and d2 = (d1 + off) mod D, each
//   delta exact over every window that holds d1 or d2 (both changes applied);
//   S2 / S4 re-derived on the changed rows; S3 is 0 (totals are unchanged).
// - [D·E + R, W): O swap diagonals, slot j·D + d swapping days d and d + δ_j
//   (δ_j >= 14, so no window holds both): the sum of two ChangeDay deltas,
//   block[d, a[d+δ]] + block[d+δ, a[d]] for (hard, S1), plus S2 / S4
//   re-derived on the changed rows.  Where d + δ >= D the slot is padding:
//   invalid, d2 = D - 1, and its values are what the plain version writes
//   there (the partner employee -2: no holiday, no window term, only the
//   S2 / S4 terms of day d's employee moved to the weekday d + δ would have).
//
// Every value is a small integer: the kernel counts in int and converts once,
// so it equals the plain version's float32 sums bit for bit, whatever the
// order.  The plain version's first / second minimum tricks (its `_BIG`
// sentinels and first-index argmin) compute a minimum or maximum over the
// employees present with one or two entries changed; here that is read from
// the lane's three smallest (largest) present values with their employees, the
// same integer wherever the result is read (the sentinel never reaches an
// output: where fewer than two employees are present the term is 0).
//
// Fingerprint deltas: h(d1, e1) ^ h(d1, n1) ^ h(d2, e2) ^ h(d2, n2) for both
// lanes, through K2's own hash (fp_hash.cuh), so they equal K2a's bit for bit;
// a padding slot hashes the employee -2 as its uint32 bit pattern.
//
// The launch (ops/sched_dense.py `_launch_plan`, a pure function of (P, D, E,
// R, O, SMs)): a lane is one thread-block cluster of S blocks of kThreads
// threads (1 <= S <= kMaxSlices, the portable cluster size, and S <= D; as
// many as fit the card in one wave at kMinBlocks blocks an SM; grid P·S
// through cudaLaunchKernelEx).  Block r of a lane owns the days [D·r/S,
// D·(r+1)/S), at most `span` = ⌈D/S⌉, the words [N·r/S, N·(r+1)/S) of the
// lane's N = ⌈D/32⌉ words of days, and the random swaps [R·r/S, R·(r+1)/S).
// Four cluster barriers (phases), each split into its arrive and its wait:
//
// 1. Every read of global memory first: the lane's assignment (int16), the
//    diagonals' offsets, the block's swaps' draws and holidays, its days'
//    holiday rows.  Then its words' membership bits (row e, bit x: a[x] ==
//    e; a warp ballot a word and employee), and from them the window flags of
//    the windows that start in its words (a warp ballot 32 windows: the 14-day
//    windows that hold 3 or 4 of an employee's days, the 7-day ones 2 or 3)
//    and its words' weekday counts.  After the first barrier (every block
//    started) it stores its flag words into every block of the cluster and
//    adds its counts into every block's (distributed shared memory): the
//    lane's days are scanned once a cluster, and after the second barrier
//    every block holds the lane's flags and counts.
// 2. Then, a warp each, the three smallest present values of each weekday
//    row, and the three smallest and largest of the totals and of the weekend
//    totals, with their employees.  Every minimum or maximum that S2-S4 take
//    with one or two entries changed is read from these lists in a few
//    comparisons, with no loop over the employees.
// 3. The block's random swaps, a thread a swap: H2 / H3 from the assignment,
//    H4 / S1 as popcounts of the window flags of the windows that hold one day
//    but not the other, S2 / S4 from the lists.
// 4. Its days in chunks of at most kMaxChunk: two threads a day gather its
//    H2 / H3 partner employees and constant, its own H4 / S1 terms, holiday
//    and S2-S4 statistics; a thread a cell writes the cell's (hard, S1) as
//    two int8 into the block's plane.  The third barrier publishes the planes.
// 5. The diagonal slots (j, d), d its own days, a thread a slot: (hard, S1)
//    of cell (d, a[d + δ]) from its own plane and of (d + δ, a[d]) from the
//    plane of the block that owns day d + δ (distributed shared memory), S2
//    / S4 from the lists.
// 6. Then the bulk of the stores, after the arrive of the fourth barrier
//    (whose wait keeps every plane until the cluster has read it): a thread a
//    cell, its S2-S4 with the plane's terms and all its outputs, one
//    contiguous run of each output row (the scores one float2, the
//    fingerprints one 16-byte store); the diagonals' moves.  A barrier's
//    arrive waits for the thread's stores before it, and a shared-memory read
//    queues behind the SM's pending stores: so the stores come last, once the
//    shared-memory work is done.
//
// Shared memory is dynamic, laid out by `layout` from the plan and the same
// in every block (ops/sched_dense.py `_smem_bytes` computes the same bytes;
// the entry refuses a plan whose size differs): the assignment int16[D]; the
// block's membership words uint32[E][⌈N/S⌉ + 1]; the counts int[7][E], the
// totals and weekend totals int[E] each; the lists; kDayFields ints a day of
// the chunk; 4 hash terms a day of the span; the offsets; a batch of swaps;
// then, each where it fits, the lane's window flags uint32[4][E][N + 2], the
// block's plane int8[span][E][2] and its holiday rows float32[span][E].
// 17,968 bytes a block at (64, 365, 20, 256, 4), S = 7.  What does not fit
// lies in global memory: the flags in a [P, 4, E, N + 2] uint32 scratch, the
// plane in a [P, D, E, 2] int8 scratch (both allocated by the wrapper), the
// holiday rows read where they lie (all three at 4096 x 256).
//
// What bounds it: bytes.  Its outputs are 50 bytes a candidate (scores 8,
// fingerprints 16, the four move tensors 26: 28.8 MB at (64, 365, 20, 256,
// 4)); its inputs are the assignment, the draws and the holiday table.  Its
// operations (about 100 integer operations a cell) are a tenth of the bytes'
// time.  What the design does about the time that is not bytes: one wave of
// clusters, each lane's days scanned once a cluster, no loop over the
// employees outside the lists, no second launch, no global memory read after
// the first store.
//
// The C entry `sched_dense_launch` takes its whole plan as one int64 array
// (the layout below, written by ops/sched_dense.py `_plan_values`), checks it,
// launches on `stream` without synchronising, and returns the launch's error.
// The kernel takes its arguments as one struct by value, so a CUDA graph
// captures the launch with its arguments.  `sched_dense_occupancy` reports
// what the card makes of a plan (registers, blocks an SM, clusters at once).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "fp_hash.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;       // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;       // blocks an SM the registers leave room for (at most 64 a thread)
constexpr int kMaxDays = 4096;      // D: the lane's assignment as int16 in shared memory
constexpr int kMaxEmps = 256;       // E: an employee in 8 bits of a list key
constexpr int kMaxSlices = 8;       // blocks a lane: the portable cluster size
constexpr int kMaxChunk = 128;      // days of a chunk: the per-day fields
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may have (227 KB)
constexpr int kPlanLen = 40;        // int64 entries of the plan
constexpr int kBig = 1000000000;    // the plain version's _BIG, 1e9 (exact in float32)
constexpr int kPad = -2;            // the employee of a padding slot's partner day
constexpr int kEmpty = 0x7FFFFFFF;  // an absent entry of a list
constexpr int kKeyTop = 8191;       // a largest-first key holds kKeyTop - value (values <= kMaxDays)
constexpr int kDayFields = 18;      // int fields a day of the chunk
constexpr int kSwapFields = 4;      // int fields a random swap of a batch
constexpr int kPlanUsed = 39;       // the plan's entries that the entry reads
static_assert(kPlanUsed <= kPlanLen, "the plan's layout outgrew its length");

// The lists: 3 keys each, (value << 8) | employee, sorted; kEmpty where fewer
// are present.  0-4 the weekday rows' smallest, then the totals' smallest and
// largest, the weekend totals' smallest and largest (over the employees with
// a total day); then the present counts of the five rows and of the totals.
enum { kRow0 = 0, kTotLo = 5, kTotHi = 6, kWkLo = 7, kWkHi = 8, kLists = 9, kNp = 3 * kLists, kListWords = kNp + 6 };

// The per-day fields of a chunk, [field][day].
enum {
  fAd, fHard, fSoft, fPart0, fPart1, fPart2, fHol,
  fNp2, fM1_2, fM2_2, fNp3, fM1_3, fM2_3, fX1_3, fM1_4, fM2_4, fX1_4, fX2_4,
};
static_assert(fX2_4 + 1 == kDayFields, "the day fields and their count disagree");

// The hash terms of each of the block's days, [field][day - lo]: mix32(d ^
// salt) and h(d, a[d]), for each salt.
enum { hMix0, hMix1, hOwn0, hOwn1, kHashFields };

// A batch's random swaps, [field][swap]: its days, its employees (e1 | e2 << 16), its holiday term.
enum { sX1, sX2, sEmps, sH1 };

// The lane's window flags, [flag][employee][word]: bit 32 + w of a row is
// the window that starts at day w (a zero word on either side).  F3 / G4:
// the 14-day windows that hold 3 / 4 of the employee's days; F2 / G3: the
// 7-day windows that hold 2 / 3.  A day more crosses H4's (S1's) threshold
// from F3 (F2), a day less from G4 (G3).
enum { kF3 = 0, kG4 = 1, kF2 = 2, kG3 = 3, kFlags = 4 };

struct Layout {
  int nw;    // words of the lane's days: ⌈D/32⌉
  int nwf;   // words of a flag row: nw and a zero word on either side
  int nwl;   // words of a block's membership rows: its share of the nw words and the next
  int a, mloc, flags, cnt, tot, wk, lists, day, hash, delta, swaps, hol, plane, bytes;
};

__host__ __device__ __forceinline__ int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ __forceinline__ Layout layout(int days, int emps, int slices, int chunk, int span, int n_off,
                                                  int batch, bool flags, bool hol, bool plane) {
  Layout l;
  l.nw = (days + 31) / 32;
  l.nwf = l.nw + 2;
  l.nwl = (l.nw + slices - 1) / slices + 1;
  int at = 0;
  l.a = at;
  at += align16(2 * days);
  l.mloc = at;
  at += align16(4 * emps * l.nwl);
  l.cnt = at;
  at += align16(4 * 7 * emps);
  l.tot = at;
  at += align16(4 * emps);
  l.wk = at;
  at += align16(4 * emps);
  l.lists = at;
  at += align16(4 * kListWords);
  l.day = at;
  at += align16(4 * kDayFields * chunk);
  l.hash = at;
  at += align16(4 * kHashFields * span);
  l.delta = at;
  at += align16(4 * n_off);
  l.swaps = at;
  at += align16(4 * kSwapFields * batch);
  l.flags = at;
  at += flags ? align16(4 * kFlags * emps * l.nwf) : 0;
  l.plane = at;
  at += plane ? align16(2 * span * emps) : 0;
  l.hol = at;
  at += hol ? align16(4 * span * emps) : 0;
  l.bytes = at;
  return l;
}

struct Args {
  int lanes, days, emps, n_rand, n_off, start_weekday;
  int slices, chunk, span, swap_batch, smem, flags_shared, plane_shared, hol_shared;
  long long width;                                     // W
  const long long* assign; long long a_stride;         // [P, D], unit stride along D
  const float* cur; long long cur_stride[2];           // [P, 2]
  const float* holiday;                                // [D, E], contiguous
  const long long* rs_d1; long long rs_d1_stride[2];   // [P, R]
  const long long* rs_off; long long rs_off_stride[2]; // [P, R]
  const long long* delta; long long delta_stride[2];   // [P, O]
  float* scores;                                       // [P, W, 2]
  unsigned char* valid;                                // [P, W]
  long long* fp;                                       // [P, W, 2]
  unsigned char* is_swap;                              // [P, W]
  long long* d1;                                       // [P, W]
  long long* d2;
  long long* new_emp;
  char2* scratch;                                      // [P, D, E] (hard, S1), or null: the plane in shared memory
  uint32_t* flag_scratch;                              // [P, 4, E, nwf], or null: the flags in shared memory
};

// The cluster barrier in two halves (PTX barrier.cluster), as in block_pick.cu:
// the arrive releases this thread's reads and writes to the threads that wait
// (its global stores too, so it waits for them).
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }

__device__ __forceinline__ int weekday(const Args& g, int d) { return (g.start_weekday + d) % 7; }
__device__ __forceinline__ int weekend(const Args& g, int d) { return weekday(g, d) >= 5; }

// K bits (K <= 32) of a bit row from bit `at` on; the row has a word past the last one read.
__device__ __forceinline__ uint32_t bits_at(const uint32_t* row, int at, int k) {
  const uint32_t w = __funnelshift_r(row[at >> 5], row[(at >> 5) + 1], at & 31);
  return k == 32 ? w : w & ((1u << k) - 1u);
}

// One key into a sorted list of the three smallest keys (distinct but kEmpty).
__device__ __forceinline__ void insert3(int k, int& t0, int& t1, int& t2) {
  t2 = min(t2, max(t1, k));
  t1 = min(t1, max(t0, k));
  t0 = min(t0, k);
}

// A list's entries as values: the first two whose employee is neither x nor y
// (-1: none), `none` where fewer are left.
__device__ __forceinline__ void first_two(const int* list, bool largest, int x, int y, int none, int& v0,
                                          int& v1) {
  v0 = v1 = none;
  int n = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int k = list[i];
    if (k == kEmpty) break;
    const int e = k & 255;
    if (e == x || e == y) continue;
    const int v = largest ? kKeyTop - (k >> 8) : k >> 8;
    if (n == 0) {
      v0 = v;
    } else if (n == 1) {
      v1 = v;
    }
    ++n;
  }
}

// (m1, m2), the two smallest of a multiset, with v added (m1 <= m2).
__device__ __forceinline__ void add_min(int v, int& m1, int& m2) {
  if (v < m1) {
    m2 = m1;
    m1 = v;
  } else if (v < m2) {
    m2 = v;
  }
}

__device__ __forceinline__ void add_max(int v, int& x1, int& x2) {
  if (v > x1) {
    x2 = x1;
    x1 = v;
  } else if (v > x2) {
    x2 = v;
  }
}

// The lane's shared state, as pointers into the block's shared memory.
struct Lane {
  short* a;         // [D]
  uint32_t* mloc;   // [E][nwl]: the membership bits of the block's words k0 ... (row e, bit x: a[32·k0 + x] == e)
  uint32_t* flags;  // [4][E][nwf]: the lane's window flags, in shared memory or the global scratch
  int* cnt;         // [7][E]: days of each weekday per employee
  int* tot;         // [E]
  int* wk;          // [E]
  int* lists;       // kListWords
  int* day;         // [kDayFields][chunk]
  uint32_t* hash;   // [kHashFields][span]
  int* delta;       // [O]
  int* swaps;       // [kSwapFields][swap_batch]
  float* hol;       // [span][E]: the block's days' holiday rows, or null: read from global memory
  char2* plane;     // [span][E]: the block's cells' (hard, S1), in shared memory or the global scratch
  int nwf, nwl, chunk, span, batch, lo, hi;  // [lo, hi): the block's days
};

// S2's score of weekday row r with `minus` decremented and `plus` incremented
// (an employee out of [0, E): none): the least count among the employees
// present when more than one is, else 0.
__device__ int row_score(const Lane& s, int emps, int r, int minus, int plus) {
  const int* row = s.cnt + r * emps;
  const int* list = s.lists + 3 * (kRow0 + r);
  int np = s.lists[kNp + r];
  const bool mv = minus >= 0 && minus < emps, pv = plus >= 0 && plus < emps;
  if (minus == plus || (!mv && !pv)) return np > 1 ? (list[0] >> 8) : 0;
  int mn = kBig, unused;
  first_two(list, false, mv ? minus : -1, pv ? plus : -1, kBig, mn, unused);
  if (mv) {
    const int v = row[minus];
    np -= v == 1;
    if (v > 1) mn = min(mn, v - 1);
  }
  if (pv) {
    const int v = row[plus];
    np += v == 0;
    mn = min(mn, v + 1);
  }
  return np > 1 ? mn : 0;
}

// S4: the max - min spread of the weekend totals over the employees with a
// total day, when at least two have one, else 0; `x` gains `dw`, `y` loses it.
__device__ int spread4(const Lane& s, int emps, int x, int y, int dw) {
  const int* lo = s.lists + 3 * kWkLo;
  const int* hi = s.lists + 3 * kWkHi;
  if (s.lists[kNp + 5] < 2) return 0;
  const bool xv = x >= 0 && x < emps && s.tot[x] > 0, yv = y >= 0 && y < emps && s.tot[y] > 0;
  if (dw == 0 || x == y || (!xv && !yv)) return (kKeyTop - (hi[0] >> 8)) - (lo[0] >> 8);
  int mn, mx, unused;
  first_two(lo, false, xv ? x : -1, yv ? y : -1, kBig, mn, unused);
  first_two(hi, true, xv ? x : -1, yv ? y : -1, -kBig, mx, unused);
  if (xv) {
    mn = min(mn, s.wk[x] + dw);
    mx = max(mx, s.wk[x] + dw);
  }
  if (yv) {
    mn = min(mn, s.wk[y] - dw);
    mx = max(mx, s.wk[y] - dw);
  }
  return mx - mn;
}

__device__ __forceinline__ int s3_base(const Lane& s) {
  return s.lists[kNp + 5] >= 2 ? (kKeyTop - (s.lists[3 * kTotHi] >> 8)) - (s.lists[3 * kTotLo] >> 8) : 0;
}

__device__ __forceinline__ int s4_base(const Lane& s) {
  return s.lists[kNp + 5] >= 2 ? (kKeyTop - (s.lists[3 * kWkHi] >> 8)) - (s.lists[3 * kWkLo] >> 8) : 0;
}

__device__ __forceinline__ int rs_old(const Lane& s, int r) {
  return s.lists[kNp + r] > 1 ? s.lists[3 * (kRow0 + r)] >> 8 : 0;
}

// h(pos, v) XOR-ed into the pair (h0, h1), one lane salt each.
__device__ __forceinline__ void hash_in(uint32_t& h0, uint32_t& h1, uint32_t pos, uint32_t v) {
  h0 ^= fp_hash::hash(pos, v, fp_hash::kSalt0);
  h1 ^= fp_hash::hash(pos, v, fp_hash::kSalt1);
}

// A candidate's move and fingerprint delta (42 of its 50 bytes), and its scores.
__device__ __forceinline__ void write_move(const Args& g, long long at, bool ok, bool swap, int day1, int day2,
                                           int emp, uint32_t f0, uint32_t f1) {
  g.valid[at] = ok;
  g.is_swap[at] = swap;
  g.d1[at] = day1;
  g.d2[at] = day2;
  g.new_emp[at] = emp;
  reinterpret_cast<longlong2*>(g.fp)[at] = make_longlong2(f0, f1);
}

__device__ __forceinline__ void write_scores(const Args& g, long long at, float2 cur, float dh, float ds) {
  reinterpret_cast<float2*>(g.scores)[at] = make_float2(cur.x + dh, cur.y + ds);
}

// n elements of src into dst, a thread an element, four loads in flight before their stores.
template <typename T, typename U>
__device__ __forceinline__ void copy_in(U* dst, const T* __restrict__ src, int n) {
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u * kThreads < n) v[u] = src[i0 + u * kThreads];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u * kThreads < n) dst[i0 + u * kThreads] = static_cast<U>(v[u]);
    }
  }
}

// Flag f's k bits of employee e from the window that starts at day w on (w >= -32).
__device__ __forceinline__ uint32_t flag_bits(const Lane& s, int emps, int f, int e, int w, int k) {
  return bits_at(s.flags + (f * emps + e) * s.nwf, w + 32, k);
}

// ---------------------------------------------------------------- the lane's aggregates and lists

// Bits of word k of the lane's days on weekday c.
__device__ __forceinline__ uint32_t weekday_mask(const Args& g, int c, int k) {
  const int x0 = 32 * k;
  if (x0 >= g.days) return 0u;
  const int first = ((c - g.start_weekday - x0) % 7 + 14) % 7;  // the first bit on weekday c
  const uint32_t m = 0x10204081u << first;                      // bits first, first + 7, ...
  const int n = g.days - x0;
  return n >= 32 ? m : m & ((1u << n) - 1u);
}

// The membership bits of the block's words [k0, k1] (the last one the next
// block's first, or past the lane's days): a warp ballot a word and employee.
__device__ void membership(const Args& g, const Lane& s, int k0, int k1, int warp, int lane) {
  const int D = g.days, E = g.emps;
  for (int k = k0 + warp; k <= k1; k += kWarps) {
    const int x = 32 * k + lane;
    const int v = x < D ? s.a[x] : -1;
    for (int eb = 0; eb < E; eb += 32) {
      const int n = min(32, E - eb);
      uint32_t mine = 0u;
      for (int u = 0; u < n; ++u) {
        const uint32_t m = __ballot_sync(0xffffffffu, v == eb + u);
        if (lane == u) mine = m;
      }
      if (lane < n) s.mloc[(eb + lane) * s.nwl + (k - k0)] = mine;
    }
  }
}

// The window flags of the windows that start in the block's words [k0, k1),
// a warp an (employee, word): into every block of the cluster (lane l stores
// flag l % 4 into block l / 4) or, once, into the global scratch.
__device__ void window_flags(const Args& g, const Lane& s, int k0, int k1, int warp, int lane) {
  const int D = g.days, E = g.emps, S = g.slices, nk = k1 - k0;
  for (int it = warp; it < E * nk; it += kWarps) {
    const int e = it / nk, k = k0 + (it - e * nk);
    const int w = 32 * k + lane;
    const uint32_t* row = s.mloc + e * s.nwl;
    int c14 = -1, c7 = -1;
    if (w <= D - 14) c14 = __popc(bits_at(row, w - 32 * k0, 14));
    if (w <= D - 7) c7 = __popc(bits_at(row, w - 32 * k0, 7));
    const uint32_t f3 = __ballot_sync(0xffffffffu, c14 == 3);
    const uint32_t g4 = __ballot_sync(0xffffffffu, c14 == 4);
    const uint32_t f2 = __ballot_sync(0xffffffffu, c7 == 2);
    const uint32_t g3 = __ballot_sync(0xffffffffu, c7 == 3);
    const int f = lane & 3, b = lane >> 2;
    const uint32_t word = f == kF3 ? f3 : f == kG4 ? g4 : f == kF2 ? f2 : g3;
    const int at = (f * E + e) * s.nwf + 1 + k;
    if (g.flag_scratch != nullptr || S == 1) {
      if (b == 0) s.flags[at] = word;
    } else if (b < S) {
      cg::this_cluster().map_shared_rank(s.flags, b)[at] = word;
    }
  }
}

// The weekday counts of the block's words [k0, k1), added into every block's.
__device__ void weekday_counts(const Args& g, const Lane& s, int k0, int k1) {
  const int E = g.emps, S = g.slices;
  for (int i = threadIdx.x; i < 7 * E; i += kThreads) {
    const int c = i / E, e = i - c * E;
    int n = 0;
    for (int k = k0; k < k1; ++k) n += __popc(s.mloc[e * s.nwl + (k - k0)] & weekday_mask(g, c, k));
    if (S == 1) {
      s.cnt[i] = n;
    } else if (n != 0) {
      cg::cluster_group cluster = cg::this_cluster();
      for (int b = 0; b < S; ++b) atomicAdd(cluster.map_shared_rank(s.cnt, b) + i, n);
    }
  }
}

// Warp `warp` reduces its lists: the three smallest (largest) keys of the
// employees present, and the present counts.  The totals' and weekend totals'
// own warps also write them.
__device__ void lane_lists(const Args& g, const Lane& s, int warp, int lane) {
  const int E = g.emps;
  for (int l = warp; l < kLists; l += kWarps) {
    int t0 = kEmpty, t1 = kEmpty, t2 = kEmpty, np = 0;
    for (int e = lane; e < E; e += 32) {
      int v, key;
      bool present;
      if (l < kTotLo) {
        v = s.cnt[l * E + e];
        present = v > 0;
        key = (v << 8) | e;
      } else {
        int t = 0;
#pragma unroll
        for (int c = 0; c < 7; ++c) t += s.cnt[c * E + e];
        const int w = s.cnt[5 * E + e] + s.cnt[6 * E + e];
        if (l == kTotLo) s.tot[e] = t;
        if (l == kWkLo) s.wk[e] = w;
        present = t > 0;
        v = l <= kTotHi ? t : w;
        key = (l == kTotLo || l == kWkLo ? v : kKeyTop - v) << 8 | e;
      }
      if (present) {
        insert3(key, t0, t1, t2);
        ++np;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int u0 = __shfl_xor_sync(0xffffffffu, t0, o);
      const int u1 = __shfl_xor_sync(0xffffffffu, t1, o);
      const int u2 = __shfl_xor_sync(0xffffffffu, t2, o);
      insert3(u0, t0, t1, t2);
      insert3(u1, t0, t1, t2);
      insert3(u2, t0, t1, t2);
    }
    np = __reduce_add_sync(0xffffffffu, np);
    if (lane == 0) {
      s.lists[3 * l] = t0;
      s.lists[3 * l + 1] = t1;
      s.lists[3 * l + 2] = t2;
      if (l <= kTotLo) s.lists[kNp + l] = np;
    }
  }
}

// ---------------------------------------------------------------- the block's days

// The block's days' hash terms: a thread a day of [lo, hi).
__device__ void day_hashes(const Lane& s, int lo, int hi) {
  for (int j = threadIdx.x; j < hi - lo; j += kThreads) {
    const uint32_t d = static_cast<uint32_t>(lo + j), ad = static_cast<uint32_t>(s.a[lo + j]);
    const uint32_t m0 = fp_hash::mix32(d ^ fp_hash::kSalt0), m1 = fp_hash::mix32(d ^ fp_hash::kSalt1);
    s.hash[hMix0 * s.span + j] = m0;
    s.hash[hMix1 * s.span + j] = m1;
    s.hash[hOwn0 * s.span + j] = fp_hash::mix32(ad ^ m0);
    s.hash[hOwn1 * s.span + j] = fp_hash::mix32(ad ^ m1);
  }
}

__device__ __forceinline__ int& day_at(const Lane& s, int field, int j) { return s.day[field * s.chunk + j]; }

// h(d, a[d]) ^ h(d, v) for each salt, d = lo + k one of the block's days.
__device__ __forceinline__ void day_hash(const Lane& s, int k, uint32_t v, uint32_t& f0, uint32_t& f1) {
  f0 = s.hash[hOwn0 * s.span + k] ^ fp_hash::mix32(v ^ s.hash[hMix0 * s.span + k]);
  f1 = s.hash[hOwn1 * s.span + k] ^ fp_hash::mix32(v ^ s.hash[hMix1 * s.span + k]);
}

// The holiday flag of (d, e), d one of the block's days.
__device__ __forceinline__ float holiday(const Args& g, const Lane& s, int d, int e) {
  return s.hol != nullptr ? s.hol[(d - s.lo) * g.emps + e] : g.holiday[d * g.emps + e];
}

// Day j's S2-S4 statistics with a[d] = ad's day removed (the plain version's
// per-day first / second minimum and maximum), from the lists.
__device__ void day_stats(const Args& g, const Lane& s, int j, int ad, int w, int wf) {
  const int E = g.emps;
  // S2: the weekday row with a[d]'s day removed.
  int np2 = 0, m1_2 = kBig, m2_2 = kBig;
  if (w < 5) {
    const int v = s.cnt[w * E + ad];
    first_two(s.lists + 3 * (kRow0 + w), false, ad, -1, kBig, m1_2, m2_2);
    if (v > 1) add_min(v - 1, m1_2, m2_2);
    np2 = s.lists[kNp + w] - (v == 1);
  }
  // S3 / S4: the totals and weekend totals with a[d]'s day removed, over the
  // employees that keep a total day.
  const int t = s.tot[ad], v4 = s.wk[ad] - wf;
  int m1_3, m2_3, x1_3, unused, m1_4, m2_4, x1_4, x2_4;
  first_two(s.lists + 3 * kTotLo, false, ad, -1, kBig, m1_3, m2_3);
  first_two(s.lists + 3 * kTotHi, true, ad, -1, -kBig, x1_3, unused);
  first_two(s.lists + 3 * kWkLo, false, ad, -1, kBig, m1_4, m2_4);
  first_two(s.lists + 3 * kWkHi, true, ad, -1, -kBig, x1_4, x2_4);
  if (t > 1) {
    add_min(t - 1, m1_3, m2_3);
    x1_3 = max(x1_3, t - 1);
    add_min(v4, m1_4, m2_4);
    add_max(v4, x1_4, x2_4);
  }
  day_at(s, fNp2, j) = np2;
  day_at(s, fM1_2, j) = m1_2;
  day_at(s, fM2_2, j) = m2_2;
  day_at(s, fNp3, j) = s.lists[kNp + 5] - (t == 1);
  day_at(s, fM1_3, j) = m1_3;
  day_at(s, fM2_3, j) = m2_3;
  day_at(s, fX1_3, j) = x1_3;
  day_at(s, fM1_4, j) = m1_4;
  day_at(s, fM2_4, j) = m2_4;
  day_at(s, fX1_4, j) = x1_4;
  day_at(s, fX2_4, j) = x2_4;
}

// Two threads a day of [c0, c1): one its H2 / H3 partners and constant, its
// own H4 / S1 terms and its holiday; the other its S2-S4 statistics.
__device__ void day_terms(const Args& g, const Lane& s, int c0, int c1) {
  const int D = g.days, E = g.emps, half = kThreads / 2;
  const bool stats = threadIdx.x >= half;  // the block's second half takes the statistics
  for (int j = threadIdx.x % half; j < c1 - c0; j += half) {
    const int d = c0 + j, ad = s.a[d], w = weekday(g, d), wf = w >= 5;
    if (stats) {
      day_stats(g, s, j, ad, w, wf);
      continue;
    }
    // H2 and H3 as partners: the cell (d, e) gains one for each partner equal
    // to e, on top of the day's constant.  H2: the pairs (d - 1, d), (d, d + 1).
    int part[6] = {-1, -1, -1, -1, -1, -1};
    int hard = 0;
    if (d >= 1) {
      part[0] = s.a[d - 1];
      hard -= part[0] == ad;
    }
    if (d <= D - 2) {
      part[1] = s.a[d + 1];
      hard -= part[1] == ad;
    }
    // H3: the weekend windows at w0 = d - q that hold d at position q.  They
    // start on a Saturday, so a day is in at most two (q = 0 and 7 on a
    // Saturday, 1 and 8 on a Sunday): at most four partners.
    int n = 2;
#pragma unroll
    for (int qi = 0; qi < 4; ++qi) {
      const int q = qi < 2 ? qi : qi + 5;  // 0, 1, 7, 8
      const int w0 = d - q;
      if (w0 < 0 || w0 > D - 9 || !(weekend(g, w0) && weekend(g, w0 + 1))) continue;
      const int a0 = s.a[w0], a1 = s.a[w0 + 1], a7 = s.a[w0 + 7], a8 = s.a[w0 + 8];
      const int was = (a0 == a7) + (a0 == a8) + (a1 == a7) + (a1 == a8);
      int u, v, kept;
      if (q < 2) {  // the pairs (q, 7) and (q, 8) change; the other first day's stay
        const int o = q == 0 ? a1 : a0;
        u = a7;
        v = a8;
        kept = (o == a7) + (o == a8);
      } else {  // the pairs (0, q) and (1, q) change; the other last day's stay
        const int o = q == 7 ? a8 : a7;
        u = a0;
        v = a1;
        kept = (a0 == o) + (a1 == o);
      }
      hard += kept - was;
      if (n <= 4) {
        part[n] = u;
        part[n + 1] = v;
        n += 2;
      }
    }
    hard -= __popc(flag_bits(s, E, kG4, ad, d - 13, 14));  // windows [d - 13, d] that lose a[d]'s fourth day
    day_at(s, fAd, j) = ad;
    day_at(s, fHard, j) = hard;
    day_at(s, fSoft, j) = -__popc(flag_bits(s, E, kG3, ad, d - 6, 7));  // [d - 6, d], its third
#pragma unroll
    for (int i = 0; i < 3; ++i) {  // two int16 a word, -1 for none
      const uint32_t lo16 = static_cast<uint32_t>(part[2 * i]) & 0xFFFFu;
      day_at(s, fPart0 + i, j) = static_cast<int>(lo16 | (static_cast<uint32_t>(part[2 * i + 1]) << 16));
    }
    day_at(s, fHol, j) = __float_as_int(holiday(g, s, d, ad));
  }
}

__device__ __forceinline__ int partners(int packed, int e) {
  return (static_cast<short>(packed & 0xFFFF) == e) + ((packed >> 16) == e);
}

// ---------------------------------------------------------------- K5a, the ChangeDay block

// The first pass: each cell's hard delta and S1 into the plane (the terms
// that need no lane aggregate).
__device__ void cell_planes(const Args& g, const Lane& s, int c0, int c1) {
  const int E = g.emps, lo = s.lo, cells = (c1 - c0) * E;
  int j = threadIdx.x / E, e = threadIdx.x - j * E;  // the thread's cell, (j, e) = divmod(i, E)
  const int step_j = kThreads / E, step_e = kThreads - step_j * E;
  for (int i = threadIdx.x; i < cells; i += kThreads, j += step_j, e += step_e) {
    if (e >= E) {
      e -= E;
      ++j;
    }
    const int d = c0 + j, ad = day_at(s, fAd, j);
    int hard = day_at(s, fHard, j) + partners(day_at(s, fPart0, j), e) + partners(day_at(s, fPart1, j), e) +
               partners(day_at(s, fPart2, j), e);
    hard += __popc(flag_bits(s, E, kF3, e, d - 13, 14));  // H4: windows [d - 13, d] that gain e's fourth day
    const int s1 = day_at(s, fSoft, j) + __popc(flag_bits(s, E, kF2, e, d - 6, 7));  // S1: e's third
    const float hol = holiday(g, s, d, e) - __int_as_float(day_at(s, fHol, j));
    const float dh = e == ad ? 0.0f : hol + static_cast<float>(hard);
    s.plane[(d - lo) * E + e] = make_char2(static_cast<signed char>(dh), static_cast<signed char>(s1));
  }
}

// The second pass: each cell's S2-S4 with the plane's terms, and every
// output of the cell.
__device__ void cell_outputs(const Args& g, const Lane& s, int p, int c0, int c1, float2 cur) {
  const int E = g.emps, lo = s.lo, cells = (c1 - c0) * E;
  const int s3b = s3_base(s), s4b = s4_base(s);
  const long long base = static_cast<long long>(p) * g.width + static_cast<long long>(c0) * E;
  int j = threadIdx.x / E, e = threadIdx.x - j * E;  // the thread's cell, (j, e) = divmod(i, E)
  const int step_j = kThreads / E, step_e = kThreads - step_j * E;
  for (int i = threadIdx.x; i < cells; i += kThreads, j += step_j, e += step_e) {
    if (e >= E) {
      e -= E;
      ++j;
    }
    const int d = c0 + j, ad = day_at(s, fAd, j), w = weekday(g, d), wf = w >= 5;
    const int own = e == ad;
    const char2 b = s.plane[(d - lo) * E + e];
    // S2: the weekday row with a[d] moved to e.
    int s2 = 0;
    if (w < 5) {
      const int v = s.cnt[w * E + e] - own;
      const int m1 = day_at(s, fM1_2, j);
      const int loo = (v > 0 && v == m1) ? day_at(s, fM2_2, j) : m1;
      const int np = day_at(s, fNp2, j) + (v == 0);
      s2 = (np > 1 ? min(v + 1, loo) : 0) - rs_old(s, w);
    }
    // S3 / S4: the totals and weekend totals with a[d]'s day moved to e.
    const int v3 = s.tot[e] - own, v4 = s.wk[e] - wf * own, present = v3 > 0;
    const int np3 = day_at(s, fNp3, j) + (v3 == 0);
    int s3 = -s3b, s4 = -s4b;
    if (np3 >= 2) {
      const int m1_3 = day_at(s, fM1_3, j), m1_4 = day_at(s, fM1_4, j), x1_4 = day_at(s, fX1_4, j);
      const int lo3 = (present && v3 == m1_3) ? day_at(s, fM2_3, j) : m1_3;
      s3 += max(day_at(s, fX1_3, j), v3 + 1) - min(v3 + 1, lo3);
      const int lo4 = (present && v4 == m1_4) ? day_at(s, fM2_4, j) : m1_4;
      const int hi4 = (present && v4 == x1_4) ? day_at(s, fX2_4, j) : x1_4;
      s4 += max(v4 + wf, hi4) - min(v4 + wf, lo4);
    }
    const float dh = static_cast<float>(b.x);  // 0 for the identity move
    const float ds = own ? 0.0f : static_cast<float>(b.y + s2 + s3 + s4);
    uint32_t f0, f1;
    day_hash(s, d - lo, e, f0, f1);
    write_scores(g, base + i, cur, dh, ds);
    write_move(g, base + i, true, false, d, d, e, f0, f1);
  }
}

// ---------------------------------------------------------------- K5c, the random swaps

// The employee on day x after swapping days x1 (gets y1) and x2 (gets y2).
__device__ __forceinline__ int after(const Lane& s, int x, int x1, int y1, int x2, int y2) {
  return x == x1 ? y1 : x == x2 ? y2 : s.a[x];
}

// A count family's change (K days; `up`: the windows one day short of its
// threshold, `down`: the windows at it) over the windows that hold x1 or x2
// but not both: e1 leaves x1 for x2, e2 the other way (e1 != e2).
__device__ __forceinline__ int count_change(const Lane& s, int emps, int k, int up, int down, int x1, int x2,
                                            int e1, int e2) {
  const int dx = x2 - x1, n = min(abs(dx), k);
  const uint32_t low = (1u << n) - 1u, all = (1u << k) - 1u;
  const uint32_t only1 = dx > 0 ? low : all & ~(all >> n);  // windows of x1 without x2, from x1 - k + 1 on
  const uint32_t only2 = dx > 0 ? all & ~(all >> n) : low;  // windows of x2 without x1, from x2 - k + 1 on
  const int w1 = x1 - k + 1, w2 = x2 - k + 1;
  return __popc(only1 & flag_bits(s, emps, up, e2, w1, k)) - __popc(only1 & flag_bits(s, emps, down, e1, w1, k)) +
         __popc(only2 & flag_bits(s, emps, up, e1, w2, k)) - __popc(only2 & flag_bits(s, emps, down, e2, w2, k));
}

__device__ __forceinline__ int& swap_at(const Lane& s, int field, int k) { return s.swaps[field * s.batch + k]; }

// Swaps [b0, b0 + nb)'s draws, a thread a swap: d1 and the offset.
__device__ void swap_draws(const Args& g, const Lane& s, int p, int b0, int nb) {
  for (int k = threadIdx.x; k < nb; k += kThreads) {
    const int r = b0 + k;
    swap_at(s, sX1, k) = static_cast<int>(g.rs_d1[p * g.rs_d1_stride[0] + r * g.rs_d1_stride[1]]);
    swap_at(s, sX2, k) = static_cast<int>(g.rs_off[p * g.rs_off_stride[0] + r * g.rs_off_stride[1]]);
  }
}

// Then, with the assignment: their days, employees and holiday term.
__device__ void swap_days(const Args& g, const Lane& s, int nb) {
  const int D = g.days, E = g.emps;
  for (int k = threadIdx.x; k < nb; k += kThreads) {
    const int x1 = swap_at(s, sX1, k), x2 = (x1 + swap_at(s, sX2, k)) % D;
    const int e1 = s.a[x1], e2 = s.a[x2];
    const float* hol = g.holiday;
    const float h1 = (hol[x1 * E + e2] - hol[x1 * E + e1]) + (hol[x2 * E + e1] - hol[x2 * E + e2]);
    swap_at(s, sX2, k) = x2;
    swap_at(s, sEmps, k) = e1 | (e2 << 16);
    swap_at(s, sH1, k) = __float_as_int(h1);
  }
}

// Swaps [b0, b0 + nb)'s moves and fingerprint deltas, a thread a swap.
__device__ void swap_moves(const Args& g, const Lane& s, int p, int b0, int nb) {
  const long long base = static_cast<long long>(p) * g.width + static_cast<long long>(g.days) * g.emps;
  for (int k = threadIdx.x; k < nb; k += kThreads) {
    const int x1 = swap_at(s, sX1, k), x2 = swap_at(s, sX2, k), es = swap_at(s, sEmps, k);
    const int e1 = es & 0xFFFF, e2 = es >> 16;
    uint32_t f0 = 0, f1 = 0;
    hash_in(f0, f1, x1, e1);
    hash_in(f0, f1, x1, e2);
    hash_in(f0, f1, x2, e2);
    hash_in(f0, f1, x2, e1);
    write_move(g, base + b0 + k, true, true, x1, x2, 0, f0, f1);
  }
}

// Swaps [b0, b0 + nb)'s scores, a thread a swap: H2 and H3 from the
// assignment, each window once; H4 and S1 from the window flags; S2 / S4 from
// the lists.
__device__ void swap_scores(const Args& g, const Lane& s, int p, int b0, int nb, float2 cur) {
  const int D = g.days, E = g.emps;
  const long long base = static_cast<long long>(p) * g.width + static_cast<long long>(D) * E;
  for (int k = threadIdx.x; k < nb; k += kThreads) {
    const int x1 = swap_at(s, sX1, k), x2 = swap_at(s, sX2, k), es = swap_at(s, sEmps, k);
    const int e1 = es & 0xFFFF, e2 = es >> 16;
    int hard = 0, soft = 0;
    if (e1 != e2) {  // else the swap changes no day
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int x = r ? x2 : x1;
        for (int w = max(0, x - 1); w <= min(x, D - 2); ++w) {  // H2: the pairs that hold x
          if (r == 1 && w >= x1 - 1 && w <= x1) continue;
          hard += (after(s, w, x1, e2, x2, e1) == after(s, w + 1, x1, e2, x2, e1)) - (s.a[w] == s.a[w + 1]);
        }
        for (int w = max(0, x - 8); w <= min(x, D - 9); ++w) {  // H3: the weekend windows that hold x
          if ((r == 1 && w >= x1 - 8 && w <= x1) || !(weekend(g, w) && weekend(g, w + 1))) continue;
          int now = 0, was = 0;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int jj = 7; jj < 9; ++jj) {
              now += after(s, w + i, x1, e2, x2, e1) == after(s, w + jj, x1, e2, x2, e1);
              was += s.a[w + i] == s.a[w + jj];
            }
          }
          hard += now - was;
        }
      }
      hard += count_change(s, E, 14, kF3, kG4, x1, x2, e1, e2);  // H4
      soft += count_change(s, E, 7, kF2, kG3, x1, x2, e1, e2);   // S1
    }
    const int w1 = weekday(g, x1), w2 = weekday(g, x2);
    if (w1 != w2) {  // on one weekday the row keeps its counts
      if (w1 < 5) soft += row_score(s, E, w1, e1, e2) - rs_old(s, w1);
      if (w2 < 5) soft += row_score(s, E, w2, e2, e1) - rs_old(s, w2);
    }
    const int dw = (w1 >= 5) - (w2 >= 5);
    if (dw != 0 && e1 != e2) soft += spread4(s, E, e2, e1, dw) - s4_base(s);
    write_scores(g, base + b0 + k, cur, __int_as_float(swap_at(s, sH1, k)) + static_cast<float>(hard),
                 static_cast<float>(soft));
  }
}

// ---------------------------------------------------------------- K5b, the swap diagonals

// The moves and fingerprint deltas of the block's diagonal slots (j, d), d
// its own days, from the assignment alone.
__device__ void diagonal_moves(const Args& g, const Lane& s, int p) {
  const int D = g.days, E = g.emps, lo = s.lo, nt = s.hi - lo;
  for (int i = threadIdx.x; i < g.n_off * nt; i += kThreads) {
    const int j = i / nt, k = i - j * nt, d = lo + k;
    const int far = d + s.delta[j], ok = far <= D - 1;
    const int a1 = s.a[d], a2 = ok ? s.a[far] : kPad, d2 = min(far, D - 1);
    // h(d, a1) ^ h(d, a2) ^ h(d2, a2) ^ h(d2, a1); the padding's employee -2 hashes as its bit pattern
    uint32_t f0, f1;
    day_hash(s, k, static_cast<uint32_t>(a2), f0, f1);
    hash_in(f0, f1, d2, static_cast<uint32_t>(a2));
    hash_in(f0, f1, d2, a1);
    write_move(g, static_cast<long long>(p) * g.width + static_cast<long long>(D) * E + g.n_rand +
                      static_cast<long long>(j) * D + d,
               ok, true, d, d2, 0, f0, f1);
  }
}

// Slot (j, d)'s scores: the (hard, S1) of cell (d, a[d + δ]) from the block's
// own plane and of (d + δ, a[d]) from the plane of the block that owns day
// d + δ (distributed shared memory, or the global scratch), and S2 / S4.
__device__ void diagonal_scores(const Args& g, const Lane& s, int p, int j, int d, float2 cur) {
  const int D = g.days, E = g.emps, S = g.slices;
  const int dl = s.delta[j];
  const int far = d + dl, ok = far <= D - 1;
  const int a1 = s.a[d], a2 = ok ? s.a[far] : kPad;
  int hard = 0, soft = 0;
  if (a1 != a2) {
    if (ok) {
      char2 tb;
      if (g.scratch == nullptr) {
        const int r = ((far + 1) * S - 1) / D;  // the block that owns day far
        const int lo_far = static_cast<int>(static_cast<long long>(D) * r / S);
        const char2* plane = S > 1 ? cg::this_cluster().map_shared_rank(s.plane, r) : s.plane;
        tb = plane[(far - lo_far) * E + a1];
      } else {
        tb = g.scratch[(static_cast<long long>(p) * D + far) * E + a1];
      }
      const char2 ta = s.plane[(d - s.lo) * E + a2];
      hard = ta.x + tb.x;
      soft = ta.y + tb.y;
    }
    const int w1 = weekday(g, d), w2 = (w1 + dl) % 7;
    if (w1 != w2) {  // the two days on one weekday keep its row's counts
      if (w1 < 5) soft += row_score(s, E, w1, a1, a2) - rs_old(s, w1);
      if (w2 < 5) soft += row_score(s, E, w2, a2, a1) - rs_old(s, w2);
    }
    const int dw = (w1 >= 5) - (w2 >= 5);
    if (dw != 0) soft += spread4(s, E, a2, a1, dw) - s4_base(s);
  }
  const long long at = static_cast<long long>(p) * g.width + static_cast<long long>(D) * E + g.n_rand +
                       static_cast<long long>(j) * D + d;
  write_scores(g, at, cur, static_cast<float>(hard), static_cast<float>(soft));
}

// ---------------------------------------------------------------- the kernel

__global__ void __launch_bounds__(kThreads, kMinBlocks) sched_dense_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = g.slices, D = g.days, E = g.emps;
  const int rank = S > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int p = blockIdx.x / S;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int lo = static_cast<int>(static_cast<long long>(D) * rank / S);
  const int hi = static_cast<int>(static_cast<long long>(D) * (rank + 1) / S);
  const Layout L = layout(D, E, S, g.chunk, g.span, g.n_off, g.swap_batch, g.flags_shared != 0, g.hol_shared != 0,
                          g.plane_shared != 0);
  Lane s;
  s.a = reinterpret_cast<short*>(smem + L.a);
  s.mloc = reinterpret_cast<uint32_t*>(smem + L.mloc);
  s.flags = g.flags_shared ? reinterpret_cast<uint32_t*>(smem + L.flags)
                           : g.flag_scratch + static_cast<long long>(p) * kFlags * E * L.nwf;
  s.cnt = reinterpret_cast<int*>(smem + L.cnt);
  s.tot = reinterpret_cast<int*>(smem + L.tot);
  s.wk = reinterpret_cast<int*>(smem + L.wk);
  s.lists = reinterpret_cast<int*>(smem + L.lists);
  s.day = reinterpret_cast<int*>(smem + L.day);
  s.hash = reinterpret_cast<uint32_t*>(smem + L.hash);
  s.delta = reinterpret_cast<int*>(smem + L.delta);
  s.swaps = reinterpret_cast<int*>(smem + L.swaps);
  s.hol = g.hol_shared ? reinterpret_cast<float*>(smem + L.hol) : nullptr;
  s.plane = g.plane_shared ? reinterpret_cast<char2*>(smem + L.plane)
                           : g.scratch + (static_cast<long long>(p) * D + lo) * E;
  s.nwf = L.nwf;
  s.nwl = L.nwl;
  s.chunk = g.chunk;
  s.span = g.span;
  s.batch = g.swap_batch;
  s.lo = lo;
  s.hi = hi;
  const int k0 = L.nw * rank / S, k1 = L.nw * (rank + 1) / S;  // the block's words of the lane's days
  const int r0 = static_cast<int>(static_cast<long long>(g.n_rand) * rank / S);
  const int r1 = static_cast<int>(static_cast<long long>(g.n_rand) * (rank + 1) / S);
  const int nb0 = min(s.batch, r1 - r0);

  // 1. Zero the counts and the flag rows' outer words (the shared ones), and
  // tell the cluster; then every read of global memory before the first
  // store: the assignment, the diagonals' offsets, the first batch of random
  // swaps, the block's holiday rows, the current scores.
  for (int i = t; i < 7 * E; i += kThreads) s.cnt[i] = 0;
  if (g.flags_shared || rank == 0) {
    for (int i = t; i < kFlags * E; i += kThreads) {
      s.flags[i * L.nwf] = 0u;
      s.flags[i * L.nwf + L.nwf - 1] = 0u;
    }
  }
  if (S > 1) cluster_arrive();  // first phase: this block has started and zeroed its counts
  copy_in(s.a, g.assign + p * g.a_stride, D);
  for (int j = t; j < g.n_off; j += kThreads) {
    s.delta[j] = static_cast<int>(g.delta[p * g.delta_stride[0] + j * g.delta_stride[1]]);
  }
  swap_draws(g, s, p, r0, nb0);
  if (s.hol != nullptr) copy_in(s.hol, g.holiday + static_cast<long long>(lo) * E, (hi - lo) * E);
  const float2 cur = make_float2(g.cur[p * g.cur_stride[0]], g.cur[p * g.cur_stride[0] + g.cur_stride[1]]);
  __syncthreads();

  // Then the block's share of the lane: its words' membership bits, then their
  // window flags and weekday counts into every block of the cluster.
  swap_days(g, s, nb0);
  day_hashes(s, lo, hi);
  membership(g, s, k0, k1, warp, lane);
  __syncthreads();
  if (S > 1) cluster_wait();  // first phase complete: every block has started
  window_flags(g, s, k0, k1, warp, lane);
  weekday_counts(g, s, k0, k1);
  if (S > 1) {
    cluster_arrive();  // second phase: the flags and counts are written
    cluster_wait();
  } else {
    __syncthreads();
  }

  // 2-4. The lists; the random swaps, a batch at a time (the first read at the
  // start); the block's cells' planes, chunk by chunk, published to the
  // cluster.
  lane_lists(g, s, warp, lane);
  __syncthreads();
  for (int b0 = r0; b0 < r1; b0 += s.batch) {
    const int nb = min(s.batch, r1 - b0);
    if (b0 != r0) {
      __syncthreads();  // the previous batch is done with the fields
      swap_draws(g, s, p, b0, nb);
      __syncthreads();
      swap_days(g, s, nb);
      __syncthreads();
    }
    swap_scores(g, s, p, b0, nb, cur);
    swap_moves(g, s, p, b0, nb);
  }
  const int chunks = (hi - lo + g.chunk - 1) / g.chunk;
  for (int c0 = lo; c0 < hi; c0 += g.chunk) {
    const int c1 = min(hi, c0 + g.chunk);
    if (c0 != lo) __syncthreads();  // the previous chunk's cells have read its fields
    day_terms(g, s, c0, c1);
    __syncthreads();
    cell_planes(g, s, c0, c1);
  }
  if (!g.plane_shared) __threadfence();  // the scratch plane, to the cluster's readers
  const bool publish = S > 1 && g.n_off > 0;
  if (publish) cluster_arrive();  // third phase: the planes are written
  __syncthreads();

  // 5. The diagonals' scores, from the planes.
  if (publish) cluster_wait();
  const int nt = hi - lo;
  for (int i = t; i < g.n_off * nt; i += kThreads) {
    const int j = i / nt;
    diagonal_scores(g, s, p, j, lo + (i - j * nt), cur);
  }

  // 6. Most of the stores: the cells' outputs and the diagonals' moves, after
  // the arrive that publishes this block's reads of the planes (an arrive
  // waits for the stores before it); every block's plane stays until the
  // cluster has read it.
  if (publish) cluster_arrive();  // fourth phase: this block has read the planes
  for (int c0 = lo; c0 < hi; c0 += g.chunk) {
    const int c1 = min(hi, c0 + g.chunk);
    if (chunks > 1) {  // the fields of this chunk again
      __syncthreads();
      day_terms(g, s, c0, c1);
      __syncthreads();
    }
    cell_outputs(g, s, p, c0, c1, cur);
  }
  diagonal_moves(g, s, p);
  if (publish) cluster_wait();
}

}  // namespace

// The plan, int64 entries (ops/sched_dense.py `_plan_values`):
//   0 P, 1 D, 2 E, 3 R, 4 O, 5 start weekday, 6 slices S, 7 chunk, 8 span,
//   9 dynamic shared memory bytes, 10 W, 11 assign, 12 its row stride, 13 cur,
//   14-15 its strides, 16 holiday, 17 rs_d1, 18 rs_off, 19 delta (each pointer,
//   0 when the dimension is 0), 20-21 rs_d1's strides, 22-23 rs_off's, 24-25
//   delta's, 26 scores, 27 valid, 28 fp, 29 is_swap, 30 d1, 31 d2, 32 new_emp,
//   33 the scratch plane or 0, 34 1 when the plane lies in shared memory, 35
//   the random swaps a batch, 36 1 when the block's holiday rows lie in shared
//   memory, 37 1 when the window flags lie in shared memory, 38 the flags'
//   scratch or 0, 39 unused (0).  Returns cudaErrorInvalidValue for a plan
//   the kernel does not take.
static cudaError_t parse_plan(const long long* plan, Args& g) {
  if (plan == nullptr) return cudaErrorInvalidValue;
  g = Args{};
  g.lanes = static_cast<int>(plan[0]);
  g.days = static_cast<int>(plan[1]);
  g.emps = static_cast<int>(plan[2]);
  g.n_rand = static_cast<int>(plan[3]);
  g.n_off = static_cast<int>(plan[4]);
  g.start_weekday = static_cast<int>(plan[5]);
  g.slices = static_cast<int>(plan[6]);
  g.chunk = static_cast<int>(plan[7]);
  g.span = static_cast<int>(plan[8]);
  g.smem = static_cast<int>(plan[9]);
  g.width = plan[10];
  g.assign = reinterpret_cast<const long long*>(plan[11]);
  g.a_stride = plan[12];
  g.cur = reinterpret_cast<const float*>(plan[13]);
  g.cur_stride[0] = plan[14];
  g.cur_stride[1] = plan[15];
  g.holiday = reinterpret_cast<const float*>(plan[16]);
  g.rs_d1 = reinterpret_cast<const long long*>(plan[17]);
  g.rs_off = reinterpret_cast<const long long*>(plan[18]);
  g.delta = reinterpret_cast<const long long*>(plan[19]);
  g.rs_d1_stride[0] = plan[20];
  g.rs_d1_stride[1] = plan[21];
  g.rs_off_stride[0] = plan[22];
  g.rs_off_stride[1] = plan[23];
  g.delta_stride[0] = plan[24];
  g.delta_stride[1] = plan[25];
  g.scores = reinterpret_cast<float*>(plan[26]);
  g.valid = reinterpret_cast<unsigned char*>(plan[27]);
  g.fp = reinterpret_cast<long long*>(plan[28]);
  g.is_swap = reinterpret_cast<unsigned char*>(plan[29]);
  g.d1 = reinterpret_cast<long long*>(plan[30]);
  g.d2 = reinterpret_cast<long long*>(plan[31]);
  g.new_emp = reinterpret_cast<long long*>(plan[32]);
  g.scratch = reinterpret_cast<char2*>(plan[33]);
  g.plane_shared = static_cast<int>(plan[34]);
  g.swap_batch = static_cast<int>(plan[35]);
  g.hol_shared = static_cast<int>(plan[36]);
  g.flags_shared = static_cast<int>(plan[37]);
  g.flag_scratch = reinterpret_cast<uint32_t*>(plan[38]);
  if (g.lanes < 1 || g.days < 1 || g.days > kMaxDays || g.emps < 1 || g.emps > kMaxEmps || g.n_rand < 0 ||
      g.n_off < 0 || g.start_weekday < 0 || g.start_weekday > 6 || g.slices < 1 || g.slices > kMaxSlices ||
      g.slices > g.days || g.span != (g.days + g.slices - 1) / g.slices ||
      g.chunk != (g.span < kMaxChunk ? g.span : kMaxChunk) ||
      static_cast<long long>(g.lanes) * g.slices > 0x7FFFFFFFLL ||
      g.width != static_cast<long long>(g.days) * g.emps + g.n_rand + static_cast<long long>(g.n_off) * g.days ||
      (g.plane_shared != 0 && g.plane_shared != 1) || (g.hol_shared != 0 && g.hol_shared != 1) ||
      (g.flags_shared != 0 && g.flags_shared != 1) || (g.plane_shared == 0) != (g.scratch != nullptr) ||
      (g.flags_shared == 0) != (g.flag_scratch != nullptr) ||
      g.swap_batch != min(kThreads, (g.n_rand + g.slices - 1) / g.slices)) {
    return cudaErrorInvalidValue;
  }
  const Layout l = layout(g.days, g.emps, g.slices, g.chunk, g.span, g.n_off, g.swap_batch, g.flags_shared != 0,
                          g.hol_shared != 0, g.plane_shared != 0);
  if (l.bytes != g.smem || g.smem > kSmemMax) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The launch of a parsed plan: grid P·S in clusters of S; above 48 KB of
// shared memory the kernel's limit raised first, once a device.
static cudaError_t launch_config(const Args& g, cudaStream_t stream, cudaLaunchAttribute* cluster,
                                 cudaLaunchConfig_t& config) {
  static int allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (g.smem > 48 * 1024 && (device >= 64 || allowed[device] < g.smem)) {
    err = cudaFuncSetAttribute(sched_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    if (device < 64) allowed[device] = kSmemMax;
  }
  config = {};
  config.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(g.lanes) * g.slices));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(g.smem);
  config.stream = stream;
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = g.slices;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = g.slices > 1 ? 1 : 0;
  return cudaSuccess;
}

extern "C" int sched_dense_launch(const long long* plan, void* stream) {
  Args g;
  cudaError_t err = parse_plan(plan, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster[1];
  cudaLaunchConfig_t config;
  err = launch_config(g, static_cast<cudaStream_t>(stream), cluster, config);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&config, sched_dense_kernel, g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of a plan, for its log: out[0] the kernel's registers a
// thread, out[1] its local memory bytes a thread (spills), out[2] its blocks
// that fit an SM at the plan's shared memory, out[3] the clusters of the plan
// that the card holds at once (with S = 1: blocks).  Launches nothing.
extern "C" int sched_dense_occupancy(const long long* plan, int* out) {
  Args g;
  cudaError_t err = parse_plan(plan, g);
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidValue);
  cudaLaunchAttribute cluster[1];
  cudaLaunchConfig_t config;
  err = launch_config(g, nullptr, cluster, config);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, sched_dense_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], sched_dense_kernel, kThreads, config.dynamicSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[3] = 0;
  if (g.slices > 1) {
    err = cudaOccupancyMaxActiveClusters(&out[3], sched_dense_kernel, &config);
  } else {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    out[3] = out[2] * sms;
  }
  return static_cast<int>(err);
}
