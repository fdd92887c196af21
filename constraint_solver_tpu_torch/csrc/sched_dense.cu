// K5, the roster's dense neighborhood on Hopper (sm_90a): `sched_dense_kernel`
// (the ChangeDay block, K5a, and the random swaps, K5c, in one launch) and
// `sched_diag_kernel` (the swap diagonals, K5b).
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
// Every value is a small integer: the kernels count in int and convert once,
// so they equal the plain version's float32 sums bit for bit, whatever the
// order.  The plain version's first / second minimum tricks (its `_BIG`
// sentinels and first-index argmin) compute a minimum over the employees
// present with one entry changed; here that is a leave-one-out minimum from
// the two smallest values of the row (with their multiplicity), the same
// integer wherever the result is read (the sentinel never reaches an output:
// where fewer than two employees are present the term is 0).
//
// Fingerprint deltas: h(d1, e1) ^ h(d1, n1) ^ h(d2, e2) ^ h(d2, n2) for both
// lanes, through K2's own hash (fp_hash.cuh), so they equal K2a's bit for bit;
// a padding slot hashes the employee -2 as its uint32 bit pattern.
//
// The launch (ops/sched_dense.py `_launch_plan`, a pure function of (P, D, E,
// R, O, SMs)), blocks of kThreads threads:
//
// - `sched_dense_kernel`: first P·S swap blocks (lane, kThreads swaps, a
//   thread a swap), then P·T tile blocks (lane, `tile` days: every cell of
//   those days, a thread a cell in turn).  The swap blocks come first so
//   their longer threads start first.  Every block loads its lane's
//   assignment (int16 in shared memory; D <= kMaxDays) and counts its
//   weekday rows, totals and weekend totals there (shared-memory atomics),
//   the lane's aggregates that S2-S4 read: one pass over the lane's D days,
//   a few KB, from L2 after the first block.  A tile block then counts the
//   14- and 7-day windows of each employee that hold one of its days (a halo
//   of 13 days), and the per-day row statistics of S2-S4 (a thread a day),
//   and writes its cells; where the diagonals follow it also writes each
//   cell's (hard, S1) delta as two int8 into a [P, D, E, 2] scratch.
// - `sched_diag_kernel` (only where O > 0): P·G blocks of kThreads slots of
//   the lane's O·D diagonal slots, a thread a slot, reading the scratch at
//   the two cells its swap needs (L2-resident: 0.9 MB at 64 x 365 x 20).
//
// No block holds a whole [D, E] plane: at 730 x 40 one float32 plane is 117
// KB.  Shared memory is static, at most about 35 KB a block.
//
// What bounds it: bytes.  Its outputs are 50 bytes a candidate (scores 8,
// fingerprints 16, the four move tensors 26: 28.8 MB at (64, 365, 20, 256,
// 4)); its inputs are the assignment, the draws and the holiday table.  Its
// operations (about 100 integer operations a cell, 1,200 a random swap) are
// a tenth of the bytes' time.
//
// The C entry `sched_dense_launch` takes its whole plan as one int64 array
// (the layout below, written by ops/sched_dense.py `_plan_values`), checks it,
// launches on `stream` without synchronising, and returns cudaGetLastError().
// The kernels take their arguments as one struct by value, so a CUDA graph
// captures the launches with their arguments.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_hash.cuh"

namespace {

constexpr int kThreads = 256;      // threads of a block, both kernels
constexpr int kMaxDays = 4096;     // D: the lane's assignment as int16 in shared memory
constexpr int kMaxEmps = 256;      // E: the weekday rows, totals and counts in shared memory
constexpr int kMaxTile = 256;      // days of a tile block
constexpr int kMaxCounts = 4096;   // int8 window counts of a tile: (tile + 13) · E
constexpr int kPlanLen = 36;       // int64 entries of the plan
constexpr int kBig = 1000000000;   // the plain version's _BIG, 1e9 (exact in float32)
constexpr int kPad = -2;           // the employee of a padding slot's partner day
constexpr int kPlanUsed = 34;      // the plan's entries that the entry reads
static_assert(kPlanUsed <= kPlanLen, "the plan's layout outgrew its length");

struct Args {
  int lanes, days, emps, n_rand, n_off, start_weekday;
  int tile, tiles, swap_blocks, diag_blocks;
  long long width;                          // W
  const long long* assign; long long a_stride;  // [P, D], unit stride along D
  const float* cur; long long cur_stride[2];     // [P, 2]
  const float* holiday;                     // [D, E], contiguous
  const long long* rs_d1; long long rs_d1_stride[2];   // [P, R]
  const long long* rs_off; long long rs_off_stride[2]; // [P, R]
  const long long* delta; long long delta_stride[2];   // [P, O]
  float* scores;                            // [P, W, 2]
  unsigned char* valid;                     // [P, W]
  long long* fp;                            // [P, W, 2]
  unsigned char* is_swap;                   // [P, W]
  long long* d1;                            // [P, W]
  long long* d2;
  long long* new_emp;
  signed char* block;                       // [P, D, E, 2] scratch, or null without diagonals
};

// The lane's assignment and aggregates, in every block.
struct Lane {
  short a[kMaxDays];
  int wd[5][kMaxEmps];   // days of each weekday Mon-Fri per employee (the plain version's c_base)
  int tot[kMaxEmps];     // days per employee
  int wk[kMaxEmps];      // weekend days per employee
  int rs_old[5];         // S2's score of each weekday row
  int s3_base, s4_base;  // the S3 and S4 spreads
};

// A tile block's windows and per-day statistics.
struct Tile {
  signed char c14[kMaxCounts];  // [s - lo14][e]: employee e's days in the 14-day window at s
  signed char c7[kMaxCounts];   // the same for 7 days
  // Per day of the tile: S2 over the weekday row with a[d] removed; S3 and S4
  // over the totals and weekend totals with a[d] removed, on the employees
  // present in the totals.
  int np2[kMaxTile], m1_2[kMaxTile], m2_2[kMaxTile];
  int np3[kMaxTile], m1_3[kMaxTile], m2_3[kMaxTile], x1_3[kMaxTile];
  int m1_4[kMaxTile], m2_4[kMaxTile], x1_4[kMaxTile], x2_4[kMaxTile];
};

__device__ __forceinline__ int weekday(const Args& g, int d) { return (g.start_weekday + d) % 7; }
__device__ __forceinline__ int weekend(const Args& g, int d) { return weekday(g, d) >= 5; }

__device__ __forceinline__ void push_min(int v, int& m1, int& m2) {
  if (v < m1) {
    m2 = m1;
    m1 = v;
  } else if (v < m2) {
    m2 = v;
  }
}

__device__ __forceinline__ void push_max(int v, int& x1, int& x2) {
  if (v > x1) {
    x2 = x1;
    x1 = v;
  } else if (v > x2) {
    x2 = v;
  }
}

// S2's score of a weekday row: the least count among the employees present
// (count > 0) when more than one is, else 0.  The row is `row` with `minus`
// decremented and `plus` incremented (-1 or an employee out of range: none).
__device__ int row_score(const int* row, int emps, int minus, int plus) {
  int np = 0, mn = kBig;
  for (int e = 0; e < emps; ++e) {
    const int v = row[e] - (e == minus) + (e == plus);
    if (v > 0) {
      ++np;
      mn = min(mn, v);
    }
  }
  return np > 1 ? mn : 0;
}

// S4: the max - min spread of the weekend totals over the employees with a
// total day, when at least two have one, else 0; `x` gains `dw`, `y` loses it.
__device__ int spread4(const Lane& s, int emps, int x, int y, int dw) {
  int np = 0, mn = kBig, mx = -kBig;
  for (int e = 0; e < emps; ++e) {
    if (s.tot[e] > 0) {
      const int v = s.wk[e] + (e == x ? dw : 0) - (e == y ? dw : 0);
      ++np;
      mn = min(mn, v);
      mx = max(mx, v);
    }
  }
  return np >= 2 ? mx - mn : 0;
}

// Loads lane p's assignment and counts its aggregates; every thread of the
// block takes part, and the block is synchronised on return.
__device__ void load_lane(const Args& g, int p, Lane& s) {
  const int D = g.days, E = g.emps;
  const long long* row = g.assign + p * g.a_stride;
  for (int d = threadIdx.x; d < D; d += kThreads) s.a[d] = static_cast<short>(row[d]);
  for (int i = threadIdx.x; i < 7 * E; i += kThreads) {
    if (i < 5 * E) {
      s.wd[i / E][i % E] = 0;
    } else if (i < 6 * E) {
      s.tot[i - 5 * E] = 0;
    } else {
      s.wk[i - 6 * E] = 0;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const int e = s.a[d];
    if (e < 0 || e >= E) continue;  // a precondition: every employee in [0, E)
    const int w = weekday(g, d);
    atomicAdd(&s.tot[e], 1);
    if (w >= 5) {
      atomicAdd(&s.wk[e], 1);
    } else {
      atomicAdd(&s.wd[w][e], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < 5) {
    s.rs_old[threadIdx.x] = row_score(s.wd[threadIdx.x], E, -1, -1);
  } else if (threadIdx.x == 32) {
    int np = 0, mn3 = kBig, mx3 = -kBig;
    for (int e = 0; e < E; ++e) {
      if (s.tot[e] > 0) {
        ++np;
        mn3 = min(mn3, s.tot[e]);
        mx3 = max(mx3, s.tot[e]);
      }
    }
    s.s3_base = np >= 2 ? mx3 - mn3 : 0;
    s.s4_base = spread4(s, E, -1, -1, 0);
  }
  __syncthreads();
}

// h(pos, v) XOR-ed into the pair (h0, h1), one lane salt each.
__device__ __forceinline__ void hash_in(uint32_t& h0, uint32_t& h1, uint32_t pos, uint32_t v) {
  h0 ^= fp_hash::hash(pos, v, fp_hash::kSalt0);
  h1 ^= fp_hash::hash(pos, v, fp_hash::kSalt1);
}

__device__ __forceinline__ void write_move(const Args& g, long long at, int p, float dh, float ds, bool ok,
                                           bool swap, int day1, int day2, int emp) {
  const float cur_h = g.cur[p * g.cur_stride[0]], cur_s = g.cur[p * g.cur_stride[0] + g.cur_stride[1]];
  g.scores[2 * at] = cur_h + dh;
  g.scores[2 * at + 1] = cur_s + ds;
  g.valid[at] = ok;
  g.is_swap[at] = swap;
  g.d1[at] = day1;
  g.d2[at] = day2;
  g.new_emp[at] = emp;
}

// ---------------------------------------------------------------- K5c, the random swaps

// The employee on day x after swapping days x1 (gets y1) and x2 (gets y2).
__device__ __forceinline__ int after(const Lane& s, int x, int x1, int y1, int x2, int y2) {
  return x == x1 ? y1 : x == x2 ? y2 : s.a[x];
}

// The change of one window family over the windows that hold day x1 or x2:
// starts in [dj - K + 1, dj] for dj = x1, then x2 without x1's.  K = 2: H2;
// 9: H3; 14: H4 (more than 3 days of an employee); 7: S1 (more than 2).
template <int K>
__device__ int window_delta(const Args& g, const Lane& s, int x1, int x2, int e1, int e2) {
  const int D = g.days;
  int total = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int dj = r ? x2 : x1;
    const int lo = max(0, dj - K + 1), hi = min(dj, D - K);
    for (int w = lo; w <= hi; ++w) {
      if (r == 1 && w >= x1 - K + 1 && w <= x1) continue;
      if (K == 2) {
        total += (after(s, w, x1, e2, x2, e1) == after(s, w + 1, x1, e2, x2, e1)) -
                 (s.a[w] == s.a[w + 1]);
      } else if (K == 9) {
        if (!(weekend(g, w) && weekend(g, w + 1))) continue;
        int now = 0, was = 0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 7; j < 9; ++j) {
            now += after(s, w + i, x1, e2, x2, e1) == after(s, w + j, x1, e2, x2, e1);
            was += s.a[w + i] == s.a[w + j];
          }
        }
        total += now - was;
      } else {
        constexpr int kThresh = K == 14 ? 3 : 2;
        int old1 = 0, new1 = 0, old2 = 0, new2 = 0;
        for (int k = 0; k < K; ++k) {
          const int x = w + k;
          const int was = s.a[x], now = after(s, x, x1, e2, x2, e1);
          old1 += was == e1;
          new1 += now == e1;
          old2 += was == e2;
          new2 += now == e2;
        }
        total += (new1 > kThresh) - (old1 > kThresh);
        if (e2 != e1) total += (new2 > kThresh) - (old2 > kThresh);
      }
    }
  }
  return total;
}

__device__ void random_swaps(const Args& g, const Lane& s, int p, int chunk) {
  const int k = chunk * kThreads + threadIdx.x;
  if (k >= g.n_rand) return;
  const int D = g.days, E = g.emps;
  const int x1 = static_cast<int>(g.rs_d1[p * g.rs_d1_stride[0] + k * g.rs_d1_stride[1]]);
  const int off = static_cast<int>(g.rs_off[p * g.rs_off_stride[0] + k * g.rs_off_stride[1]]);
  const int x2 = (x1 + off) % D;
  const int e1 = s.a[x1], e2 = s.a[x2];
  const float* hol = g.holiday;
  const float h1 = (hol[x1 * E + e2] - hol[x1 * E + e1]) + (hol[x2 * E + e1] - hol[x2 * E + e2]);
  const int hard = window_delta<2>(g, s, x1, x2, e1, e2) + window_delta<9>(g, s, x1, x2, e1, e2) +
                   window_delta<14>(g, s, x1, x2, e1, e2);
  int soft = window_delta<7>(g, s, x1, x2, e1, e2);
  const int w1 = weekday(g, x1), w2 = weekday(g, x2);
  if (w1 != w2) {  // on one weekday the row keeps its counts
    if (w1 < 5) soft += row_score(s.wd[w1], E, e1, e2) - s.rs_old[w1];
    if (w2 < 5) soft += row_score(s.wd[w2], E, e2, e1) - s.rs_old[w2];
  }
  const int dw = (w1 >= 5) - (w2 >= 5);
  if (dw != 0 && e1 != e2) soft += spread4(s, E, e2, e1, dw) - s.s4_base;
  const long long at = static_cast<long long>(p) * g.width + static_cast<long long>(D) * E + k;
  write_move(g, at, p, h1 + static_cast<float>(hard), static_cast<float>(soft), true, true, x1, x2, 0);
  uint32_t f0 = 0, f1 = 0;
  hash_in(f0, f1, x1, e1);
  hash_in(f0, f1, x1, e2);
  hash_in(f0, f1, x2, e2);
  hash_in(f0, f1, x2, e1);
  g.fp[2 * at] = f0;
  g.fp[2 * at + 1] = f1;
}

// ---------------------------------------------------------------- K5a, the ChangeDay block

__device__ void change_day_tile(const Args& g, const Lane& s, Tile& t, int p, int tile) {
  const int D = g.days, E = g.emps;
  const int t0 = tile * g.tile, t1 = min(D, t0 + g.tile), nt = t1 - t0;
  const int lo14 = max(0, t0 - 13), hi14 = min(t1 - 1, D - 14);
  const int lo7 = max(0, t0 - 6), hi7 = min(t1 - 1, D - 7);
  const int n14 = max(0, hi14 - lo14 + 1) * E, n7 = max(0, hi7 - lo7 + 1) * E;
  for (int i = threadIdx.x; i < n14 + n7; i += kThreads) {
    const bool wide = i < n14;
    const int j = wide ? i : i - n14;
    const int w = (wide ? lo14 : lo7) + j / E, e = j % E, width = wide ? 14 : 7;
    int c = 0;
    for (int k = 0; k < width; ++k) c += s.a[w + k] == e;
    (wide ? t.c14 : t.c7)[j] = static_cast<signed char>(c);
  }
  for (int j = threadIdx.x; j < nt; j += kThreads) {
    const int d = t0 + j, ad = s.a[d], w = weekday(g, d), wf = w >= 5;
    int np2 = 0, m1_2 = kBig, m2_2 = kBig;
    int np3 = 0, m1_3 = kBig, m2_3 = kBig, x1_3 = -kBig;
    int m1_4 = kBig, m2_4 = kBig, x1_4 = -kBig, x2_4 = -kBig;
    for (int e = 0; e < E; ++e) {
      const int own = e == ad;
      if (w < 5) {
        const int v2 = s.wd[w][e] - own;
        if (v2 > 0) {
          ++np2;
          push_min(v2, m1_2, m2_2);
        }
      }
      const int v3 = s.tot[e] - own;
      if (v3 > 0) {
        const int v4 = s.wk[e] - wf * own;
        ++np3;
        push_min(v3, m1_3, m2_3);
        x1_3 = max(x1_3, v3);
        push_min(v4, m1_4, m2_4);
        push_max(v4, x1_4, x2_4);
      }
    }
    t.np2[j] = np2, t.m1_2[j] = m1_2, t.m2_2[j] = m2_2;
    t.np3[j] = np3, t.m1_3[j] = m1_3, t.m2_3[j] = m2_3, t.x1_3[j] = x1_3;
    t.m1_4[j] = m1_4, t.m2_4[j] = m2_4, t.x1_4[j] = x1_4, t.x2_4[j] = x2_4;
  }
  __syncthreads();

  const long long base = static_cast<long long>(p) * g.width;
  for (int i = threadIdx.x; i < nt * E; i += kThreads) {
    const int j = i / E, e = i % E, d = t0 + j, ad = s.a[d];
    const int w = weekday(g, d), wf = w >= 5;
    // H2: the pairs (d - 1, d) and (d, d + 1).
    int h2 = 0;
    if (d >= 1) h2 += (s.a[d - 1] == e) - (s.a[d - 1] == ad);
    if (d <= D - 2) h2 += (s.a[d + 1] == e) - (ad == s.a[d + 1]);
    // H3: the weekend windows at s = d - q that hold d at position q.
    int h3 = 0;
#pragma unroll
    for (int qi = 0; qi < 4; ++qi) {
      const int q = qi < 2 ? qi : qi + 5;  // 0, 1, 7, 8
      const int w0 = d - q;
      if (w0 < 0 || w0 > D - 9 || !(weekend(g, w0) && weekend(g, w0 + 1))) continue;
      int now = 0, was = 0;
#pragma unroll
      for (int i0 = 0; i0 < 2; ++i0) {
#pragma unroll
        for (int j0 = 7; j0 < 9; ++j0) {
          const int u = s.a[w0 + i0], v = s.a[w0 + j0];
          was += u == v;
          now += (i0 == q ? e : u) == (j0 == q ? e : v);
        }
      }
      h3 += now - was;
    }
    // H4 / S1: windows holding d whose count of e is at the threshold, less
    // those whose count of a[d] is one above it.
    int h4 = 0, s1 = 0;
    for (int w0 = max(lo14, d - 13); w0 <= min(d, D - 14); ++w0) {
      const signed char* c = t.c14 + (w0 - lo14) * E;
      h4 += (c[e] == 3) - (c[ad] == 4);
    }
    for (int w0 = max(lo7, d - 6); w0 <= min(d, D - 7); ++w0) {
      const signed char* c = t.c7 + (w0 - lo7) * E;
      s1 += (c[e] == 2) - (c[ad] == 3);
    }
    // S2: the weekday row with a[d] moved to e.
    const int own = e == ad;
    int s2 = 0;
    if (w < 5) {
      const int v = s.wd[w][e] - own;
      const int loo = (v > 0 && v == t.m1_2[j]) ? t.m2_2[j] : t.m1_2[j];
      const int np = t.np2[j] + (v == 0);
      s2 = (np > 1 ? min(v + 1, loo) : 0) - s.rs_old[w];
    }
    // S3 / S4: the totals and weekend totals with a[d]'s day moved to e.
    const int v3 = s.tot[e] - own, v4 = s.wk[e] - wf * own, present = v3 > 0;
    const int np3 = t.np3[j] + (v3 == 0);
    int s3 = -s.s3_base, s4 = -s.s4_base;
    if (np3 >= 2) {
      const int lo3 = (present && v3 == t.m1_3[j]) ? t.m2_3[j] : t.m1_3[j];
      s3 += max(t.x1_3[j], v3 + 1) - min(v3 + 1, lo3);
      const int lo4 = (present && v4 == t.m1_4[j]) ? t.m2_4[j] : t.m1_4[j];
      const int hi4 = (present && v4 == t.x1_4[j]) ? t.x2_4[j] : t.x1_4[j];
      s4 += max(v4 + wf, hi4) - min(v4 + wf, lo4);
    }
    const float* hol = g.holiday + d * E;
    const float dh = own ? 0.0f : (hol[e] - hol[ad]) + static_cast<float>(h2 + h3 + h4);
    const float ds = own ? 0.0f : static_cast<float>(s1 + s2 + s3 + s4);
    const long long at = base + static_cast<long long>(d) * E + e;
    write_move(g, at, p, dh, ds, true, false, d, d, e);
    uint32_t f0 = 0, f1 = 0;
    hash_in(f0, f1, d, ad);
    hash_in(f0, f1, d, e);
    g.fp[2 * at] = f0;
    g.fp[2 * at + 1] = f1;
    if (g.block != nullptr) {
      signed char* b = g.block + 2 * ((static_cast<long long>(p) * D + d) * E + e);
      b[0] = static_cast<signed char>(dh);
      b[1] = static_cast<signed char>(s1);
    }
  }
}

__global__ void __launch_bounds__(kThreads) sched_dense_kernel(const Args g) {
  __shared__ Lane lane;
  __shared__ Tile tile;
  const int b = blockIdx.x;
  const int swaps = g.lanes * g.swap_blocks;
  const int p = b < swaps ? b / g.swap_blocks : (b - swaps) / g.tiles;
  load_lane(g, p, lane);
  if (b < swaps) {
    random_swaps(g, lane, p, b % g.swap_blocks);
  } else {
    change_day_tile(g, lane, tile, p, (b - swaps) % g.tiles);
  }
}

// ---------------------------------------------------------------- K5b, the swap diagonals

__global__ void __launch_bounds__(kThreads) sched_diag_kernel(const Args g) {
  __shared__ Lane s;
  const int p = blockIdx.x / g.diag_blocks;
  load_lane(g, p, s);
  const int slot = (blockIdx.x % g.diag_blocks) * kThreads + threadIdx.x;
  const int D = g.days, E = g.emps;
  if (slot >= g.n_off * D) return;
  const int j = slot / D, d = slot % D;
  const int dl = static_cast<int>(g.delta[p * g.delta_stride[0] + j * g.delta_stride[1]]);
  const int far = d + dl, ok = far <= D - 1;
  const int a1 = s.a[d], a2 = ok ? s.a[far] : kPad, d2 = min(far, D - 1);
  int hard = 0, soft = 0;
  if (a1 != a2) {
    if (ok) {
      const signed char* b = g.block + 2 * (static_cast<long long>(p) * D * E);
      const signed char* ta = b + 2 * (static_cast<long long>(d) * E + a2);
      const signed char* tb = b + 2 * (static_cast<long long>(far) * E + a1);
      hard = ta[0] + tb[0];
      soft = ta[1] + tb[1];
    }
    const int w1 = weekday(g, d), w2 = (w1 + dl) % 7;
    if (w1 != w2) {  // the two days on one weekday keep its row's counts
      if (w1 < 5) soft += row_score(s.wd[w1], E, a1, a2) - s.rs_old[w1];
      if (w2 < 5) soft += row_score(s.wd[w2], E, a2, a1) - s.rs_old[w2];
    }
    const int dw = (w1 >= 5) - (w2 >= 5);
    if (dw != 0) soft += spread4(s, E, a2, a1, dw) - s.s4_base;
  }
  const long long at =
      static_cast<long long>(p) * g.width + static_cast<long long>(D) * E + g.n_rand + slot;
  write_move(g, at, p, static_cast<float>(hard), static_cast<float>(soft), ok, true, d, d2, 0);
  uint32_t f0 = 0, f1 = 0;  // the padding's employee -2 hashes as its bit pattern
  hash_in(f0, f1, d, a1);
  hash_in(f0, f1, d, static_cast<uint32_t>(a2));
  hash_in(f0, f1, d2, static_cast<uint32_t>(a2));
  hash_in(f0, f1, d2, a1);
  g.fp[2 * at] = f0;
  g.fp[2 * at + 1] = f1;
}

}  // namespace

// The plan, int64 entries (ops/sched_dense.py `_plan_values`):
//   0 P, 1 D, 2 E, 3 R, 4 O, 5 start weekday, 6 tile, 7 tiles, 8 swap blocks,
//   9 diagonal blocks, 10 W, 11 assign, 12 its row stride, 13 cur, 14-15 its
//   strides, 16 holiday, 17 rs_d1, 18 rs_off, 19 delta (each pointer, 0 when
//   the dimension is 0), 20-21 rs_d1's strides, 22-23 rs_off's, 24-25 delta's,
//   26 scores, 27 valid, 28 fp, 29 is_swap, 30 d1, 31 d2, 32 new_emp, 33 the
//   scratch or 0, 34-35 unused (0).
extern "C" int sched_dense_launch(const long long* plan, void* stream) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args g{};
  g.lanes = static_cast<int>(plan[0]);
  g.days = static_cast<int>(plan[1]);
  g.emps = static_cast<int>(plan[2]);
  g.n_rand = static_cast<int>(plan[3]);
  g.n_off = static_cast<int>(plan[4]);
  g.start_weekday = static_cast<int>(plan[5]);
  g.tile = static_cast<int>(plan[6]);
  g.tiles = static_cast<int>(plan[7]);
  g.swap_blocks = static_cast<int>(plan[8]);
  g.diag_blocks = static_cast<int>(plan[9]);
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
  g.block = reinterpret_cast<signed char*>(plan[33]);
  if (g.lanes < 1 || g.days < 1 || g.days > kMaxDays || g.emps < 1 || g.emps > kMaxEmps || g.n_rand < 0 ||
      g.n_off < 0 || g.tile < 1 || g.tile > kMaxTile || (g.tile + 13) * g.emps > kMaxCounts ||
      g.tiles != (g.days + g.tile - 1) / g.tile || g.swap_blocks != (g.n_rand + kThreads - 1) / kThreads ||
      g.diag_blocks != (g.n_off * g.days + kThreads - 1) / kThreads ||
      g.width != static_cast<long long>(g.days) * g.emps + g.n_rand + static_cast<long long>(g.n_off) * g.days ||
      (g.n_off > 0) != (g.block != nullptr) || g.start_weekday < 0 || g.start_weekday > 6) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = static_cast<long long>(g.lanes) * (g.swap_blocks + g.tiles);
  sched_dense_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(g);
  if (g.n_off > 0) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sched_diag_kernel<<<static_cast<unsigned>(static_cast<long long>(g.lanes) * g.diag_blocks), kThreads, 0, s>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}
