// Float GEMM with fused bias -> ReLU -> fake-quant epilogue, for sm_90a.
//
// Replaces repro/kernels/matmul_fp.py:matmul_fp_pallas (kernel _mm_kernel).
// The kernel body is gemm.cuh's; see there for the bound on this card and
// what the design does about it.  f32 or bf16 operands are widened to f32
// in shared memory and accumulated in f32 with FFMA (no TF32); the output
// is written in the operands' dtype.
#include "gemm.cuh"

using repro::FloatEpilogue;
using repro::launch_gemm;

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).
extern "C" int matmul_fp_launch(const void* x, const void* w, const void* bias, void* out,
                                int m, int n, int k, int dtype, int bm, int bn, int bk,
                                int relu, int has_q, float qscale, float qlo, float qhi,
                                int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return REPRO_BAD_ARG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FloatEpilogue epi{static_cast<const float*>(bias), relu, has_q, qscale, qlo, qhi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gemm<float, float, float, float, float>(x, w, out, m, n, k, bm, bn, bk, epi, s);
#ifndef REPRO_CPU_SHIM
  if (dtype == 1)
    return launch_gemm<__nv_bfloat16, __nv_bfloat16, float, float, __nv_bfloat16>(
        x, w, out, m, n, k, bm, bn, bk, epi, s);
#endif
  return REPRO_BAD_ARG;
}
