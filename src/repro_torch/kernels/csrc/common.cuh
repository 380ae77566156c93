// Shared pieces of the port's hand-written Hopper kernels (sm_90a).
//
// The fused epilogues live here as __device__ functions so that the GEMMs
// (matmul_fp.cu, matmul_q16.cu) and the direct conv (conv2d.cu) run one
// copy of each, as the reference's Pallas kernels share
// repro/core/quantization.py's shift_saturate_i32 and kernels/conv2d.py's
// _float_epilogue / _q16_epilogue.
//
// Arithmetic contract (held bit for bit by the CPU tests' plain versions and
// by chip_smoke.py on the card):
//   float: acc (f32) -> + bias -> ReLU -> clip(rint(acc*2^f)/2^f, lo, hi)
//          rintf rounds half to even like jnp.round (roundf would round half
//          away from zero); no fast-math, so the divide is IEEE.
//   int:   the int32 accumulator is kept in uint32_t, so its wrap mod 2^32 is
//          defined behaviour and equals XLA's int32 dot; bias << bias_shift
//          and the rounding add are done unsigned as well; the right shift is
//          arithmetic on the signed value; shift < 0 is an exact (wrapping)
//          left shift; then the clip to [raw_min, raw_max].
#pragma once

#include <cstdint>
#include <type_traits>

#ifndef REPRO_CPU_SHIM
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#define DYN_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

namespace repro {

// ---------------------------------------------------------------------------
// element conversions
// ---------------------------------------------------------------------------

__device__ __forceinline__ float widen(float v) { return v; }
#ifndef REPRO_CPU_SHIM
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
#endif
__device__ __forceinline__ int32_t widen(int8_t v) { return v; }
__device__ __forceinline__ int32_t widen(int16_t v) { return v; }

template <typename TO> __device__ __forceinline__ TO narrow_f(float v);
template <> __device__ __forceinline__ float narrow_f<float>(float v) { return v; }
#ifndef REPRO_CPU_SHIM
template <> __device__ __forceinline__ __nv_bfloat16 narrow_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
#endif

// The byte of limb ``l`` of a raw, as the tensor-core integer routes feed
// 8-bit wgmma (gemm_q16_wgmma.cuh, conv2d_q16_tc.cuh): int16 -> hi (signed,
// plane 0), lo (unsigned, plane 1), so x = hi·2^8 + lo; int8 -> itself
// (signed, plane 0).
template <typename T>
struct Limbs;
template <>
struct Limbs<int16_t> {
  static constexpr int N = 2;
  __host__ __device__ static uint8_t byte(int32_t v, int l) {
    return static_cast<uint8_t>(l == 0 ? (v >> 8) & 0xFF : v & 0xFF);
  }
};
template <>
struct Limbs<int8_t> {
  static constexpr int N = 1;
  __host__ __device__ static uint8_t byte(int32_t v, int) {
    return static_cast<uint8_t>(v & 0xFF);
  }
};

// ---------------------------------------------------------------------------
// multiply-accumulate, one overload per accumulator kind
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mac(float& acc, float a, float b) { acc = fmaf(a, b, acc); }
__device__ __forceinline__ void mac(uint32_t& acc, int32_t a, int32_t b) {
  // |a·b| < 2^30 for int16 raws, so the product itself never overflows
  acc += static_cast<uint32_t>(a * b);
}

// ---------------------------------------------------------------------------
// epilogues
// ---------------------------------------------------------------------------

// The reference's write-back ladder (quantization.py:shift_saturate_i32).
__device__ __forceinline__ int32_t shift_saturate(int32_t acc, int shift, int raw_min,
                                                  int raw_max) {
  int32_t s;
  if (shift > 0) {
    s = static_cast<int32_t>(static_cast<uint32_t>(acc) + (1u << (shift - 1))) >> shift;
  } else if (shift == 0) {
    s = acc;
  } else {
    s = static_cast<int32_t>(static_cast<uint32_t>(acc) << (-shift));
  }
  return s < raw_min ? raw_min : (s > raw_max ? raw_max : s);
}

// Float epilogue (matmul_fp.py:_mm_kernel's write-back, conv2d.py:_float_epilogue).
struct FloatEpilogue {
  const float* bias;  // (n,) f32 or null
  int relu;
  int has_q;
  float qscale, qlo, qhi;

  template <typename TO>
  __device__ __forceinline__ TO apply(float acc, int col) const {
    if (bias != nullptr) acc = acc + bias[col];
    if (relu) acc = fmaxf(acc, 0.0f);
    if (has_q) {
      acc = rintf(acc * qscale) / qscale;
      acc = fminf(fmaxf(acc, qlo), qhi);
    }
    return narrow_f<TO>(acc);
  }
};


// Fixed-point epilogue (matmul_q16.py:_qmm_kernel, conv2d.py:_q16_epilogue):
// + (bias << bias_shift) -> ReLU on int32 -> shift_saturate onto the output
// rung, or the raw int32 accumulator when TO is int32_t (``wide``).
struct IntEpilogue {
  const int32_t* bias;  // (n,) raw, widened to int32, or null
  int bias_shift;
  int relu;
  int shift;
  int raw_min, raw_max;

  template <typename TO>
  __device__ __forceinline__ TO apply(uint32_t acc, int col) const {
    if (bias != nullptr) acc += static_cast<uint32_t>(bias[col]) << bias_shift;
    int32_t a = static_cast<int32_t>(acc);
    if (relu) a = a > 0 ? a : 0;
    if (sizeof(TO) == 4) return static_cast<TO>(a);
    return static_cast<TO>(shift_saturate(a, shift, raw_min, raw_max));
  }
};

// IntEpilogue onto a rung chosen at run time: obits 16 or 8 (the int16 or
// int8 rung) or 32 (the raw int32 accumulator, ``wide``).  The q16 GEMM's
// split-k and wgmma routes take it, so each of their kernels is compiled
// once per width mix and not once more per rung.
struct IntRungEpilogue {
  IntEpilogue epi;
  int obits;

  __device__ __forceinline__ void put(void* out, size_t i, uint32_t acc, int col) const {
    if (obits == 16)
      static_cast<int16_t*>(out)[i] = epi.apply<int16_t>(acc, col);
    else if (obits == 8)
      static_cast<int8_t*>(out)[i] = epi.apply<int8_t>(acc, col);
    else
      static_cast<int32_t*>(out)[i] = epi.apply<int32_t>(acc, col);
  }
};

// Write one result: the epilogue's value as TO, or, for TO = void, the rung
// an IntRungEpilogue names.
template <typename TO, typename Epi, typename TA>
__device__ __forceinline__ void put_out(TO* out, size_t i, const Epi& epi, TA acc, int col) {
  if constexpr (std::is_void<TO>::value) {
    epi.put(out, i, acc, col);
  } else {
    out[i] = epi.template apply<TO>(acc, col);
  }
}

// The second pass of a reduction cut across blocks (gemm_splitk.cuh's k
// slices, conv2d_tc.cuh's Cin split): out = epilogue(sum of the (splits, m,
// n) partial sums), added in split order.  No atomics: the same bits on
// every run.  TA is the accumulator: f32 partial sums under FloatEpilogue,
// uint32_t (an int32 that wraps) under IntRungEpilogue (TO = void).
template <typename TO, typename TA, typename Epi>
__global__ void __launch_bounds__(256)
    split_reduce_kernel(const TA* __restrict__ part, TO* __restrict__ out, int m, int n,
                        int splits, Epi epi) {
  const size_t mn = static_cast<size_t>(m) * n;
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= mn) return;
  TA s = TA(0);
  for (int sp = 0; sp < splits; ++sp) s += part[sp * mn + i];
  put_out(out, i, epi, s, static_cast<int>(i % n));
}

template <typename TO, typename TA, typename Epi>
inline int launch_split_reduce(const TA* part, TO* out, int m, int n, int splits,
                               const Epi& epi, cudaStream_t stream) {
  const size_t mn = static_cast<size_t>(m) * n;
  const dim3 grid(static_cast<unsigned>((mn + 255) / 256));
  auto kfn = split_reduce_kernel<TO, TA, Epi>;
  LAUNCH(kfn, grid, dim3(256), 0, stream, part, out, m, n, splits, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// Error codes the C entry points return besides cudaError_t values.
#define REPRO_BAD_ARG 1000

// Each .cu file is built into a library of its own and includes this header
// once, so this is the one definition in each library.
extern "C" const char* repro_error_string(int code) {
  if (code == REPRO_BAD_ARG) return "argument the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
