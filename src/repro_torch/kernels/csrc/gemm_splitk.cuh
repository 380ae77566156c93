// Route S of both GEMMs: split-k streaming of w, for m <= 16.
//
// Replaces, with gemm_wgmma.cuh and gemm.cuh, the TPU kernel
// repro/kernels/matmul_fp.py:_mm_kernel (via matmul_fp_pallas) for the
// skinny GEMMs: the CNNs' FC layers at batch 8 (f32), every decode GEMM at
// m = 4 (bf16) and the tied LM head; and, with gemm_q16_wgmma.cuh, the TPU
// kernel repro/kernels/matmul_q16.py:_qmm_kernel (via matmul_q16_pallas)
// for the same GEMMs on int16 / int8 raws (the grid-resident FC layers,
// decode GEMMs and LM head).
//
// What bounds it on an H100: reading w once (VGG16 fc0: 411 MB in f32, at
// 3.35 TB/s 0.123 ms; 205 MB in int16, 0.0615 ms); with m <= 16 the math
// is 2m operations per weight, below the CUDA cores' rate (integer
// multiply-adds run at half the FFMA rate: at fc0 int16 its 822 M of them
// would take about 0.05 ms on 132 SMs, close to the bytes; PERF.md records
// how far the route runs from both).  So the design is a stream:
//   * a block owns a column tile of w and one slice of k; the grid is
//     (column tiles, k slices), sized by the planner to cover the 132 SMs
//     several times, so a GEMM with few columns still spreads its weight
//     read over the card;
//   * x's slice (m x slice) is staged once per block in shared memory, in
//     f32 (int32 for raws); m is padded to a compiled row count MT, so each
//     thread keeps MT x V accumulators in registers;
//   * row-major w (k, n): 256 columns a block; each thread reads V columns
//     of a row with one vector load (16 bytes: 4 f32, 8 bf16 or 8 int16;
//     8 int8 in 8 bytes, so that MT x V stays at 128 accumulators at
//     MT = 16), neighbouring threads neighbouring bytes, eight rows at a
//     time in flight; the block's thread rows are summed through shared
//     memory in a fixed order;
//   * transposed w (embed.T, an (n, k) row-major matrix): each thread
//     takes a whole output column and streams its contiguous k-long row,
//     eight 16-byte loads (a 128-byte line) in flight, against x read as
//     shared-memory broadcasts;
//   * one slice writes the epilogue's result directly; several write
//     partial sums to a (splits, m, n) workspace, and common.cuh's
//     split_reduce_kernel adds them in slice order and runs the epilogue.
//     No atomics: the result is the same bits on every run.
// f32 stays f32 (FFMA, never TF32): the reference holds it at 1e-4.  Raws
// are widened to int32 and accumulated in uint32_t (common.cuh's mac), so
// every partial sum, and their sum, wraps mod 2^32 as the reference's int32
// dot does: any split is exact.  The transposed layout is the float GEMM's
// alone (the q16 GEMM's w is always (k, n)).  A shape whose rows are not
// aligned to the vector (n, or k when transposed, not a multiple of V)
// takes the same kernels with scalar loads.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace splitk {

constexpr int THREADS = 256;
constexpr int COLS = 256;  // columns of a block, either layout
constexpr int SLICE_ALIGN = 64;
constexpr int RED_BYTES = 8 * 4 * COLS * 4;  // thread rows x 4 rows x COLS sums

// One vector load of w: N elements widened to the staged type S (f32 for
// floats, int32 for raws), summed in the accumulator type A.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  using S = float;
  using A = float;
  __device__ __forceinline__ static void load(const float* p, float (&o)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

#ifndef REPRO_CPU_SHIM
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  using S = float;
  using A = float;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&o)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an f32
      o[2 * i] = __uint_as_float(u[i] << 16);
      o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};
#endif

// two's-complement fields of a 32-bit word, sign-extended
__device__ __forceinline__ int32_t sext16(uint32_t u, int i) {
  return static_cast<int32_t>(u << (16 - 16 * i)) >> 16;
}
__device__ __forceinline__ int32_t sext8(uint32_t u, int i) {
  return static_cast<int32_t>(u << (24 - 8 * i)) >> 24;
}

template <>
struct Vec16<int16_t> {
  static constexpr int N = 8;
  using S = int32_t;
  using A = uint32_t;
  __device__ __forceinline__ static void load(const int16_t* p, int32_t (&o)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = sext16(u[i / 2], i % 2);
  }
};

// int8: 8 bytes, 8 columns (16 columns would be 256 accumulators at MT 16)
template <>
struct Vec16<int8_t> {
  static constexpr int N = 8;
  using S = int32_t;
  using A = uint32_t;
  __device__ __forceinline__ static void load(const int8_t* p, int32_t (&o)[8]) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const uint32_t u[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = sext8(u[i / 4], i % 4);
  }
};

// V consecutive elements at p, of which the first ``valid`` exist: one
// vector load when VEC (aligned, all valid), else masked scalar loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_w(const T* p, int valid,
                                       typename Vec16<T>::S (&o)[Vec16<T>::N]) {
  using S = typename Vec16<T>::S;
  constexpr int V = Vec16<T>::N;
  if (VEC && valid >= V) {
    Vec16<T>::load(p, o);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = j < valid ? static_cast<S>(widen(p[j])) : S(0);
  }
}

// x rows [0, MT) x slice columns [k0, k0 + len) into xs as S, zero past
// m and past len; eight loads in flight a thread before any store.
template <typename T, typename S, int MT>
__device__ __forceinline__ void stage_x(S* xs, const T* x, int m, int k, int k0, int len,
                                        int slice) {
  constexpr int B = 8;
  for (int i0 = threadIdx.x; i0 < MT * slice; i0 += B * THREADS) {
    S v[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b * THREADS;
      const int r = i / slice, c = i % slice;
      v[b] = (i < MT * slice && r < m && c < len)
                 ? static_cast<S>(widen(x[static_cast<size_t>(r) * k + k0 + c]))
                 : S(0);
    }
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (i0 + b * THREADS < MT * slice) xs[i0 + b * THREADS] = v[b];
  }
}

// Eight staged x values of one row from shared memory, two 16-byte loads.
template <typename S>
__device__ __forceinline__ void load_x8(const S* p, S (&o)[8]) {
  if constexpr (std::is_same<S, float>::value) {
    const float4 x0 = *reinterpret_cast<const float4*>(p);
    const float4 x1 = *reinterpret_cast<const float4*>(p + 4);
    const float v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = v[i];
  } else {
    const uint4 x0 = *reinterpret_cast<const uint4*>(p);
    const uint4 x1 = *reinterpret_cast<const uint4*>(p + 4);
    const uint32_t v[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = static_cast<S>(v[i]);
  }
}

// Row-major w.  grid (ceil(n / COLS), splits); a thread row takes groups of
// 8 consecutive k rows, KW groups apart.  TX / TW the operands' element
// types, TO the output's; Epi the epilogue (FloatEpilogue for floats;
// IntRungEpilogue for raws, with TO = void), A its accumulator.
template <typename TX, typename TW, typename TO, typename Epi, int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
    splitk_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TO* __restrict__ out,
                  typename Vec16<TW>::A* __restrict__ part, int m, int n, int k, int slice,
                  Epi epi) {
  using S = typename Vec16<TW>::S;
  using A = typename Vec16<TW>::A;
  constexpr int V = Vec16<TW>::N;
  constexpr int CT = COLS / V;      // threads across the column tile
  constexpr int KW = THREADS / CT;  // thread rows along k: 4 (f32) or 8 (the rest)
  constexpr int RP = MT < 4 ? MT : 4;  // rows per pass of the reduction
  DYN_SMEM(smem);
  S* xs = reinterpret_cast<S*>(smem);
  const int tc = threadIdx.x % CT, tr = threadIdx.x / CT;
  const int n0 = blockIdx.x * COLS;
  const int col = n0 + tc * V;
  const int k0 = blockIdx.y * slice;
  const int len = min(k, k0 + slice) - k0;
  const int valid = col < n ? min(V, n - col) : 0;
  stage_x<TX, S, MT>(xs, x, m, k, k0, len, slice);
  __syncthreads();

  A acc[MT][V];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = A(0);

  const TW* wcol = w + col;
  for (int g = tr * 8; g < len; g += KW * 8) {  // slice % 64 == 0: g + 8 <= slice
    S wv[8][V];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      load_w<TW, VEC>(wcol + static_cast<size_t>(k0 + g + u) * n, g + u < len ? valid : 0,
                      wv[u]);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      S xv[8];
      load_x8(&xs[r * slice + g], xv);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) mac(acc[r][j], xv[u], wv[u][j]);
    }
  }

  // sum the thread rows in order, RP output rows per pass
  A* red = reinterpret_cast<A*>(smem);  // [KW][4][COLS], over x's slice once every
                                        // thread is done with it
#pragma unroll
  for (int r0 = 0; r0 < MT; r0 += RP) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) red[(tr * 4 + i) * COLS + tc * V + j] = acc[r0 + i][j];
    __syncthreads();
    for (int o = threadIdx.x; o < RP * COLS; o += THREADS) {
      const int i = o / COLS, c = o % COLS;
      A s = A(0);
      for (int t = 0; t < KW; ++t) s += red[(t * 4 + i) * COLS + c];
      const int r = r0 + i, gc = n0 + c;
      if (r < m && gc < n) {
        if (part != nullptr)
          part[(static_cast<size_t>(blockIdx.y) * m + r) * n + gc] = s;
        else
          put_out(out, static_cast<size_t>(r) * n + gc, epi, s, gc);
      }
    }
  }
}

// Transposed w: column c of the product is row c of the (n, k) matrix.
// grid (ceil(n / COLS), splits).  Thread t owns column blockIdx.x * COLS + t
// and streams that row's k slice 128 bytes at a time (U 16-byte loads in
// flight: whole lines, so every sector fetched is used); x's values are
// the same for every thread of a warp, so its shared-memory reads are
// broadcasts, and the outputs of a warp are 32 neighbouring columns.
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
    splitk_tb_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                     float* __restrict__ part, int m, int n, int k, int slice,
                     FloatEpilogue epi) {
  constexpr int V = Vec16<T>::N;
  constexpr int U = 8;
  DYN_SMEM(smem);
  float* xs = reinterpret_cast<float*>(smem);
  const int k0 = blockIdx.y * slice;
  const int len = min(k, k0 + slice) - k0;
  stage_x<T, float, MT>(xs, x, m, k, k0, len, slice);
  __syncthreads();

  const int c = blockIdx.x * COLS + threadIdx.x;
  const bool live = c < n;
  const T* wrow = w + static_cast<size_t>(live ? c : 0) * k + k0;
  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.0f;
  for (int base = 0; base < len; base += U * V) {
    float wv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = base + u * V;
      load_w<T, VEC>(wrow + kk, live && kk < len ? len - kk : 0, wv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = base + u * V;
      if (kk >= len) break;
#pragma unroll
      for (int r = 0; r < MT; ++r) {
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[r * slice + kk + j]);
          acc[r] = fmaf(xv.x, wv[u][j], acc[r]);
          acc[r] = fmaf(xv.y, wv[u][j + 1], acc[r]);
          acc[r] = fmaf(xv.z, wv[u][j + 2], acc[r]);
          acc[r] = fmaf(xv.w, wv[u][j + 3], acc[r]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    if (r >= m) break;
    if (part != nullptr)
      part[(static_cast<size_t>(blockIdx.y) * m + r) * n + c] = acc[r];
    else
      out[static_cast<size_t>(r) * n + c] = epi.template apply<T>(acc[r], c);
  }
}

template <typename TX, typename TW, typename TO, typename Epi, int MT, bool VEC>
int launch_rows(const void* x, const void* w, void* out, typename Vec16<TW>::A* part, int m,
                int n, int k, int trans_b, int slice, int splits, size_t smem, const Epi& epi,
                cudaStream_t stream) {
  const dim3 grid((n + COLS - 1) / COLS, splits);
  const dim3 block(THREADS);
  auto kfn = splitk_kernel<TX, TW, TO, Epi, MT, VEC>;
  if constexpr (std::is_same<Epi, FloatEpilogue>::value) {
    if (trans_b) kfn = splitk_tb_kernel<TW, MT, VEC>;
  } else if (trans_b) {
    return REPRO_BAD_ARG;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kfn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  LAUNCH(kfn, grid, block, smem, stream, static_cast<const TX*>(x), static_cast<const TW*>(w),
         static_cast<TO*>(out), part, m, n, k, slice, epi);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW, typename TO, typename Epi, int MT>
int launch_aligned(const void* x, const void* w, void* out, typename Vec16<TW>::A* part, int m,
                   int n, int k, int trans_b, int slice, int splits, size_t smem,
                   const Epi& epi, cudaStream_t stream) {
  constexpr int V = Vec16<TW>::N;
  const bool vec = (trans_b ? k : n) % V == 0 &&
                   reinterpret_cast<uintptr_t>(w) % (V * sizeof(TW)) == 0;
  return vec ? launch_rows<TX, TW, TO, Epi, MT, true>(x, w, out, part, m, n, k, trans_b,
                                                       slice, splits, smem, epi, stream)
             : launch_rows<TX, TW, TO, Epi, MT, false>(x, w, out, part, m, n, k, trans_b,
                                                        slice, splits, smem, epi, stream);
}

}  // namespace splitk

// Route S: x (m, k) and w (k, n) row-major, or (n, k) row-major when
// trans_b (floats only); m padded to bm in {1, 2, 4, 8, 16}; bn = 256
// columns a block; k cut into ``splits`` slices of bk rows (a multiple of
// 64).  ``part`` is the (splits, m, n) workspace of partial sums (f32, or
// uint32_t for raws), null for one slice.  The float GEMM instantiates it
// on one element type T; the q16 GEMM on its raws' types with TO = void and
// IntRungEpilogue, whose rung is chosen at run time.
template <typename TX, typename TW = TX, typename TO = TX, typename Epi = FloatEpilogue>
int launch_splitk(const void* x, const void* w, void* out, typename splitk::Vec16<TW>::A* part,
                  int m, int n, int k, int trans_b, int bm, int bn, int bk, int splits,
                  const Epi& epi, cudaStream_t stream) {
  using namespace splitk;
  if (m > bm || bn != COLS || bk <= 0 || bk % SLICE_ALIGN != 0)
    return REPRO_BAD_ARG;
  if (splits != (k + bk - 1) / bk || splits > 65535 || (splits > 1) != (part != nullptr))
    return REPRO_BAD_ARG;
  const size_t xs = static_cast<size_t>(bm) * bk * 4;
  const size_t smem = xs > RED_BYTES ? xs : RED_BYTES;
  if (smem > 232448) return REPRO_BAD_ARG;
  int rc;
  switch (bm) {
    case 1: rc = launch_aligned<TX, TW, TO, Epi, 1>(x, w, out, part, m, n, k, trans_b, bk, splits, smem, epi, stream); break;
    case 2: rc = launch_aligned<TX, TW, TO, Epi, 2>(x, w, out, part, m, n, k, trans_b, bk, splits, smem, epi, stream); break;
    case 4: rc = launch_aligned<TX, TW, TO, Epi, 4>(x, w, out, part, m, n, k, trans_b, bk, splits, smem, epi, stream); break;
    case 8: rc = launch_aligned<TX, TW, TO, Epi, 8>(x, w, out, part, m, n, k, trans_b, bk, splits, smem, epi, stream); break;
    case 16: rc = launch_aligned<TX, TW, TO, Epi, 16>(x, w, out, part, m, n, k, trans_b, bk, splits, smem, epi, stream); break;
    default: return REPRO_BAD_ARG;
  }
  if (rc != 0 || splits == 1) return rc;
  return launch_split_reduce<TO>(part, static_cast<TO*>(out), m, n, splits, epi, stream);
}

}  // namespace repro
