// Float GEMM with fused bias -> ReLU -> fake-quant epilogue, for sm_90a.
//
// Replaces repro/kernels/matmul_fp.py:matmul_fp_pallas (kernel _mm_kernel).
// The kernel body is gemm.cuh's; see there for the bound on this card and
// what the design does about it.  f32 or bf16 operands are widened to f32
// in shared memory and accumulated in f32 with FFMA (no TF32); the output
// is written in the operands' dtype.  trans_b = 1 reads w as (n, k)
// row-major (the tied LM head's embedding table).
#include "gemm.cuh"

using repro::FloatEpilogue;
using repro::launch_gemm;

namespace {

template <typename T, bool TB>
int by_tile(const void* x, const void* w, void* out, int m, int n, int k, int bm, int bn,
            int bk, const FloatEpilogue& epi, cudaStream_t s) {
  return launch_gemm<T, T, float, float, T, TB>(x, w, out, m, n, k, bm, bn, bk, epi, s);
}

template <typename T>
int by_layout(int trans_b, const void* x, const void* w, void* out, int m, int n, int k,
              int bm, int bn, int bk, const FloatEpilogue& epi, cudaStream_t s) {
  return trans_b ? by_tile<T, true>(x, w, out, m, n, k, bm, bn, bk, epi, s)
                 : by_tile<T, false>(x, w, out, m, n, k, bm, bn, bk, epi, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).
extern "C" int matmul_fp_launch(const void* x, const void* w, const void* bias, void* out,
                                int m, int n, int k, int dtype, int trans_b, int bm, int bn,
                                int bk, int relu, int has_q, float qscale, float qlo,
                                float qhi, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return REPRO_BAD_ARG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FloatEpilogue epi{static_cast<const float*>(bias), relu, has_q, qscale, qlo, qhi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_layout<float>(trans_b, x, w, out, m, n, k, bm, bn, bk, epi, s);
#ifndef REPRO_CPU_SHIM
  if (dtype == 1)
    return by_layout<__nv_bfloat16>(trans_b, x, w, out, m, n, k, bm, bn, bk, epi, s);
#endif
  return REPRO_BAD_ARG;
}
