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
// swap (3.0e8 there, 4.5 us at 67 TFLOP/s), far below the bytes.
//
// What the design does about it (a first version, right before fast):
// - A block of 8 warps owns a strip of kT = 32 rows of one lane; warp w takes
//   the strip's rows w, w + 8, w + 16 and w + 24, lane x the column b0 + x of
//   each b-tile.  The block walks the b-tiles from its own diagonal tile to n,
//   so the strict lower triangle of G and F is never read and H's is read
//   once, as the transposed term of the rows above it.
// - H[b-tile, a-strip] is staged coalesced into shared memory, each row padded
//   by one float, and read transposed without bank conflicts; H[a, b], G[a, b]
//   and F[a, b] are read coalesced straight into registers, before the
//   barrier, so all of a tile's loads are in flight together.  H[a, a] and
//   H[b, b] are read from H's diagonal; nothing else is materialized.
// - Each lane keeps (value, index) per row while it scans b upward (only a
//   strictly better pair replaces it); a warp shuffle on the pairs, ties to
//   the smaller index, finishes each row.  No cross-block pass.
// - Strip s has ceil(n/32) - s tiles, so block x takes strips x and
//   ceil(n/32) - 1 - x: every block walks the same ~n/32 + 1 tiles and no long
//   strip is left running alone at the end.  The grid is (ceil(strips/2), P).
// - rarg is written as int64 directly, and the launch sets no attribute (its
//   4.3 KB of shared memory is static), so a CUDA graph can capture it.
// Reading H once for both triangles (a block per tile pair), 16-byte loads and
// a deeper pipeline of tiles are later work.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kT = 32;       // rows of a strip, columns of a b-tile
constexpr int kWarps = 8;    // warps of a block
constexpr int kRows = kT / kWarps;  // rows of a strip per warp
constexpr int kMaxLanes = 65535;    // the grid's y dimension

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
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (better(ov, oi, v, i)) {
          v = ov;
          i = oi;
        }
      }
      const int a = a0 + w + kWarps * j;
      if (x == 0 && a < n) {
        const long long ka = static_cast<long long>(k) * n + a;
        rmin[ka] = v;
        rarg[ka] = i;
      }
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising and returns a cudaError_t (0 on
// success).  Shapes: h, g [p, n, n] and flow [n, n], contiguous; cur [p] with
// element stride cur_stride; rmin float [p, n], rarg int64 [p, n]; 1 <= p <=
// 65535, n >= 1, n * n * p addressable in 64 bits.
extern "C" int qap_row_min_launch(const void* h, const void* g, const void* flow, const void* cur,
                                  long long cur_stride, void* rmin, void* rarg, int p, int n, void* stream) {
  if (p < 1 || p > kMaxLanes || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (n + kT - 1) / kT;
  qap_row_min_kernel<<<dim3((strips + 1) / 2, p), dim3(kWarp, kWarps), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(g), static_cast<const float*>(flow),
      static_cast<const float*>(cur), cur_stride, static_cast<float*>(rmin), static_cast<long long*>(rarg), n);
  return static_cast<int>(cudaGetLastError());
}
