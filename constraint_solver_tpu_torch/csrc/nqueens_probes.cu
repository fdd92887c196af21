// The five N-Queens probe kernels of bench/kernel_iso.py on Hopper (sm_90a).
//
// Replaces the TPU kernels reached by bench/kernel_iso.py's two pallas_calls:
//   probe_base_kernel    <- _kern_base   (body :61, call :275)  f32 tables, column-dependent windows
//   probe_noroll_kernel  <- _kern_noroll (body :82, call :275)  f32 tables, fixed windows (wrong by design)
//   probe_i16_kernel     <- _kern_i16    (body :103, call :275) int16 tables
//   probe_i16min_kernel  <- _kern_i16min (body :126, call :275) int16 tables, plus each row's min and argmin
//   probe_packed_kernel  <- _kern_packed (body :157, call :222) f32 rc and one int32 table dac = dc | ac reversed << 16
//
// Each computes, for lane p, sampled column j (current row r_j) and every padded row
// i in [0, n_pad), n_pad = ceil(n / 128) * 128, from tables zero-padded to n_pad and
// 2 * n_pad (ops/nqueens_probes.py prepares them):
//
//   score[p, j, i] = cur[p] + 2 * ((rc[i] - [i==r_j]) + (dc[i+n-1-c_j] - [i==r_j]) + (ac[i+c_j] - [i==r_j])
//                                  - removed[p, j])
//
// The noroll probe reads dc[i] and ac[n_pad + i] instead and adds c_j * 0; the int16
// probes sum in int16 (wrapping as the TPU kernel does) before the cast to float32;
// the packed probe reads dc from the low halves of dac forward from o = n-1-c_j and ac
// from the high halves backward from o + n_pad - 1: hi(dac[o + n_pad - 1 - i]) = ac[i + c_j].
// Every value is a small integer, so each probe equals its plain PyTorch version bit
// for bit, padding columns included.  The row min and first argmin cover i < n.
//
// What bounds them on this card: DRAM bytes.  A probe must write the f32 scores
// [P, A, n_pad] and read its tables once; the formats differ by at most 2.5 % in
// bytes at (256, 50, 1000) and 0.3 % at (16, 819, 16384).  Arithmetic is ~8 integer
// or float32 operations per score, a tenth of the byte time.  What the formats do
// change is the shared memory one lane's tables take: 20 * n_pad bytes in f32,
// 10 * n_pad in int16, 12 * n_pad packed, against the 227 KB a block may use.
//
// What the design does about it (B1's layout, csrc/nqueens_scores.cu):
// - Grid (ceil(A/G), P): a block holds G warps, one sampled column of one lane
//   each; the launch plan (ops/nqueens_probes.py `launch_plan`) picks G.
// - Staged tables: where its format fits in 227 KB, a block copies its lane's
//   tables once into shared memory with 16-byte cp.async (int16 up to n_pad =
//   23,168, packed up to 19,328, f32 up to 11,520); above that it reads them from
//   global memory through the read-only path.  Each format stays in its own type in
//   both memories: int16 windows are loaded as 8-byte short4, f32 and int32 as
//   16-byte vectors, and widened in registers.
// - Windows: each lane of a warp takes 4 consecutive rows of a 128-row strip.  A
//   window starting at an unaligned, column-dependent offset is read as two
//   aligned vector loads and a shift that is the same for the whole warp; the noroll
//   probe's fixed windows are aligned and take one load, which is what it measures.
// - Streaming stores: every row of scores starts on 16 bytes (n_pad % 128 == 0) and
//   goes out in 16-byte `__stcs` stores, which do not evict the tables from L2.
// - The row min: each lane keeps its first minimum over its rows below n (strict <,
//   rows in ascending order); a warp shuffle on (value, index), ties to the lower
//   index, finishes it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;
constexpr int kStrip = 4 * kWarp;  // rows one warp covers per step
constexpr int kRowAlign = 128;     // n_pad is a multiple of it

enum class Table { kF32, kI16, kPacked };

// Element types: rc's, and dc's and ac's (the packed table for kPacked).
template <Table kTable> struct Types;
template <> struct Types<Table::kF32> { using Rc = float; using Diag = float; };
template <> struct Types<Table::kI16> { using Rc = short; using Diag = short; };
template <> struct Types<Table::kPacked> { using Rc = float; using Diag = int; };

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<short> { using type = short4; };
template <> struct Vec4<int> { using type = int4; };

template <typename T> struct Four { T v[4]; };

// Bytes of shared memory (and of device memory) one lane's staged tables take.
__host__ __device__ constexpr long long table_bytes(Table t, int n_pad) {
  return t == Table::kF32 ? 20LL * n_pad : t == Table::kI16 ? 10LL * n_pad : 12LL * n_pad;
}

template <bool kStaged, typename V>
__device__ __forceinline__ V load_vec(const V* q) {
  if constexpr (kStaged) {
    return *q;
  } else {
    return __ldg(q);
  }
}

template <typename V, typename T>
__device__ __forceinline__ Four<T> unpack(const V& x) {
  return {{x.x, x.y, x.z, x.w}};
}

// tab[s .. s+3] for s % 4 == 0: one vector load.
template <bool kStaged, typename T>
__device__ __forceinline__ Four<T> aligned4(const T* tab, int s) {
  using V = typename Vec4<T>::type;
  return unpack<V, T>(load_vec<kStaged>(reinterpret_cast<const V*>(tab + s)));
}

// tab[s .. s+3] for any s: two aligned vector loads and a shift by s % 4.  Callers
// pass s = w + i with i % 4 == 0, so the shift is the same for the whole warp.
// Both loads lie in the 4-element granules that hold tab[s] and tab[s + 3].
template <bool kStaged, typename T>
__device__ __forceinline__ Four<T> window4(const T* tab, int s) {
  using V = typename Vec4<T>::type;
  const int shift = s & 3;
  const V* q = reinterpret_cast<const V*>(tab + (s - shift));
  const V lo = load_vec<kStaged>(q);
  if (shift == 0) return {{lo.x, lo.y, lo.z, lo.w}};
  const V hi = load_vec<kStaged>(q + 1);
  if (shift == 1) return {{lo.y, lo.z, lo.w, hi.x}};
  if (shift == 2) return {{lo.z, lo.w, hi.x, hi.y}};
  return {{lo.w, hi.x, hi.y, hi.z}};
}

// Issues 16-byte cp.async copies of `bytes` (a multiple of 16) from 16-byte-aligned `src`.
__device__ __forceinline__ void stage(void* dst, const void* src, long long bytes) {
  const uint32_t dst_s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const char* s = static_cast<const char*>(src);
  for (long long k = threadIdx.x; k < bytes / 16; k += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst_s + 16u * static_cast<uint32_t>(k)),
                 "l"(s + 16LL * k)
                 : "memory");
  }
}

__device__ __forceinline__ void warp_min(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// One sampled column's four scores at rows i0 .. i0+3.
template <Table kTable, bool kStatic, bool kStaged>
__device__ __forceinline__ float4 scores4(const typename Types<kTable>::Rc* rc, const typename Types<kTable>::Diag* dc,
                                          const typename Types<kTable>::Diag* ac, int wd, int wa, int n_pad, int i0,
                                          int r, float base, float rem, int c) {
  float v[4];
  const auto x = aligned4<kStaged>(rc, i0);
  if constexpr (kTable == Table::kPacked) {
    const Four<int> lo = window4<kStaged>(dc, wd + i0);                   // dc forward from o
    const Four<int> hi = window4<kStaged>(dc, wd + n_pad - 4 - i0);       // ac backward from o + n_pad - 1
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float same = i0 + k == r ? 1.0f : 0.0f;
      const float dcv = static_cast<float>(lo.v[k] & 0xFFFF);
      const float acv = static_cast<float>(hi.v[3 - k] >> 16);
      const float added = (x.v[k] - same) + (dcv - same) + (acv - same);
      v[k] = base + 2.0f * (added - rem);
    }
  } else {
    using D = typename Types<kTable>::Diag;
    const Four<D> y = kStatic ? aligned4<kStaged>(dc, wd + i0) : window4<kStaged>(dc, wd + i0);
    const Four<D> z = kStatic ? aligned4<kStaged>(ac, wa + i0) : window4<kStaged>(ac, wa + i0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kTable == Table::kI16) {
        const int same = i0 + k == r ? 1 : 0;
        // The TPU kernel sums in int16; the cast back to short wraps the same way.
        const short added = static_cast<short>((x.v[k] - same) + (y.v[k] - same) + (z.v[k] - same));
        v[k] = base + 2.0f * (static_cast<float>(added) - rem);
      } else {
        const float same = i0 + k == r ? 1.0f : 0.0f;
        const float added = (x.v[k] - same) + (y.v[k] - same) + (z.v[k] - same);
        v[k] = base + 2.0f * (added - rem);
        if constexpr (kStatic) v[k] = v[k] + static_cast<float>(c) * 0.0f;
      }
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <Table kTable, bool kStatic, bool kMin, bool kStaged>
__device__ __forceinline__ void probe_body(const void* rc_in, const void* dc_in, const void* ac_in,
                                           const int* __restrict__ cols, const int* __restrict__ rows,
                                           const float* __restrict__ removed, const float* __restrict__ cur,
                                           float* __restrict__ scores, float* __restrict__ row_min,
                                           int* __restrict__ row_arg, int a, int n, int n_pad) {
  using Rc = typename Types<kTable>::Rc;
  using D = typename Types<kTable>::Diag;
  extern __shared__ float4 smem[];
  const int p = blockIdx.y;
  const Rc* rc = static_cast<const Rc*>(rc_in) + static_cast<long long>(p) * n_pad;
  const D* dc = static_cast<const D*>(dc_in) + 2LL * p * n_pad;
  const D* ac = kTable == Table::kPacked ? nullptr : static_cast<const D*>(ac_in) + 2LL * p * n_pad;
  if constexpr (kStaged) {
    Rc* s_rc = reinterpret_cast<Rc*>(smem);
    D* s_dc = reinterpret_cast<D*>(s_rc + n_pad);  // n_pad * sizeof(Rc) is a multiple of 16 bytes
    D* s_ac = s_dc + 2 * n_pad;
    stage(s_rc, rc, static_cast<long long>(n_pad) * sizeof(Rc));
    stage(s_dc, dc, 2LL * n_pad * sizeof(D));
    if constexpr (kTable != Table::kPacked) stage(s_ac, ac, 2LL * n_pad * sizeof(D));
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    rc = s_rc;
    dc = s_dc;
    ac = kTable == Table::kPacked ? nullptr : s_ac;
  }

  const int lane = threadIdx.x & (kWarp - 1);
  const int j = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (j >= a) return;  // the last block's spare warps; no barrier follows
  const long long pj = static_cast<long long>(p) * a + j;
  const int c = cols[pj];
  const int r = rows[pj];
  const float rem = removed[pj];
  const float base = cur[p];
  // The windows: dc[i + n-1-c] and ac[i + c], or the noroll probe's dc[i] and ac[n_pad + i].
  const int wd = kStatic ? 0 : n - 1 - c;
  const int wa = kStatic ? n_pad : c;
  float* out = scores + pj * n_pad;

  float best = CUDART_INF_F;
  int best_i = INT_MAX;
  for (int i0 = 4 * lane; i0 < n_pad; i0 += kStrip) {
    const float4 v = scores4<kTable, kStatic, kStaged>(rc, dc, ac, wd, wa, n_pad, i0, r, base, rem, c);
    __stcs(reinterpret_cast<float4*>(out + i0), v);
    if constexpr (kMin) {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i0 + k < n && vs[k] < best) {  // rows ascend, so strict < keeps the first
          best = vs[k];
          best_i = i0 + k;
        }
      }
    }
  }
  if constexpr (kMin) {
    warp_min(best, best_i);
    if (lane == 0) {
      row_min[pj] = best;
      row_arg[pj] = best_i;
    }
  }
}

#define PROBE_KERNEL(NAME, TABLE, STATIC, MIN)                                                                  \
  template <bool kStaged>                                                                                      \
  __global__ void __launch_bounds__(kMaxWarps * kWarp)                                                         \
      NAME(const void* rc, const void* dc, const void* ac, const int* cols, const int* rows, const float* removed, \
           const float* cur, float* scores, float* row_min, int* row_arg, int a, int n, int n_pad) {            \
    probe_body<TABLE, STATIC, MIN, kStaged>(rc, dc, ac, cols, rows, removed, cur, scores, row_min, row_arg, a, n, \
                                            n_pad);                                                             \
  }

PROBE_KERNEL(probe_base_kernel, Table::kF32, false, false)
PROBE_KERNEL(probe_noroll_kernel, Table::kF32, true, false)
PROBE_KERNEL(probe_i16_kernel, Table::kI16, false, false)
PROBE_KERNEL(probe_i16min_kernel, Table::kI16, false, true)
PROBE_KERNEL(probe_packed_kernel, Table::kPacked, false, true)

using Kernel = void (*)(const void*, const void*, const void*, const int*, const int*, const float*, const float*,
                        float*, float*, int*, int, int, int);

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

int launch(Kernel staged_kernel, Kernel global_kernel, Table table, bool with_min, const void* rc, const void* dc,
           const void* ac, const void* cols, const void* rows, const void* removed, const void* cur, void* scores,
           void* row_min, void* row_arg, int p, int a, int n, int n_pad, int cols_per_block, int grid_x,
           int smem_bytes, int staged, void* stream) {
  if (p < 1 || p > 65535 || a < 1 || n < 1 || n_pad < n || n_pad % kRowAlign != 0 || cols_per_block < 1 ||
      cols_per_block > kMaxWarps || static_cast<long long>(grid_x) * cols_per_block < a ||
      (staged && smem_bytes < table_bytes(table, n_pad)) || !aligned16(rc) || !aligned16(dc) ||
      (table != Table::kPacked && !aligned16(ac)) || !aligned16(scores) ||
      (with_min && (row_min == nullptr || row_arg == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = staged ? staged_kernel : global_kernel;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(grid_x, p), kWarp * cols_per_block, staged ? smem_bytes : 0, static_cast<cudaStream_t>(stream)>>>(
      rc, dc, ac, static_cast<const int*>(cols), static_cast<const int*>(rows), static_cast<const float*>(removed),
      static_cast<const float*>(cur), static_cast<float*>(scores), static_cast<float*>(row_min),
      static_cast<int*>(row_arg), a, n, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches on `stream` without synchronising and returns a cudaError_t
// (0 on success).  Shapes: rc [p, n_pad], dc and ac [p, 2 * n_pad] (f32 or int16;
// the packed probe's dac int32 [p, 2 * n_pad] in dc, ac unused), cols/rows/removed
// [p, a], cur [p]; scores [p, a, n_pad], row_min/row_arg [p, a] where the probe has
// them; all contiguous, tables and scores on 16 bytes.  The plan
// (ops/nqueens_probes.py `launch_plan`): grid (grid_x, p) of 32 * cols_per_block
// threads, grid_x * cols_per_block >= a; `staged` needs smem_bytes >= the tables'.
#define PROBE_ENTRY(ENTRY, KERNEL, TABLE, MIN)                                                                  \
  extern "C" int ENTRY(const void* rc, const void* dc, const void* ac, const void* cols, const void* rows,       \
                       const void* removed, const void* cur, void* scores, void* row_min, void* row_arg, int p,  \
                       int a, int n, int n_pad, int cols_per_block, int grid_x, int smem_bytes, int staged,      \
                       void* stream) {                                                                          \
    return launch(KERNEL<true>, KERNEL<false>, TABLE, MIN, rc, dc, ac, cols, rows, removed, cur, scores, row_min, \
                  row_arg, p, a, n, n_pad, cols_per_block, grid_x, smem_bytes, staged, stream);                  \
  }

PROBE_ENTRY(probe_base_launch, probe_base_kernel, Table::kF32, false)
PROBE_ENTRY(probe_noroll_launch, probe_noroll_kernel, Table::kF32, false)
PROBE_ENTRY(probe_i16_launch, probe_i16_kernel, Table::kI16, false)
PROBE_ENTRY(probe_i16min_launch, probe_i16min_kernel, Table::kI16, true)
PROBE_ENTRY(probe_packed_launch, probe_packed_kernel, Table::kPacked, true)
