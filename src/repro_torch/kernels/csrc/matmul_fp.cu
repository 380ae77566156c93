// Float GEMM with fused bias -> ReLU -> fake-quant epilogue, for sm_90a.
//
// Replaces repro/kernels/matmul_fp.py:matmul_fp_pallas (kernel _mm_kernel)
// on three routes, which the planner (core/dse.py:default_fp_block_for)
// picks from the shape, the dtype and w's layout; each header says what
// bounds its route on this card and what its design does about that:
//   route 0, "tile"   (gemm.cuh): the block-tiled CUDA-core GEMM shared with
//                     matmul_q16.cu, for f32 with m > 16 (the im2col route)
//                     and bf16 that route W cannot take;
//   route 1, "splitk" (gemm_splitk.cuh): m <= 16, w streamed once over k
//                     slices (the CNNs' FC layers, decode, the tied head);
//   route 2, "wgmma"  (gemm_wgmma.cuh): bf16 with large m on the tensor
//                     cores through TMA (the prefill's GEMMs).
// Every route computes in f32 (FFMA or wgmma's f32 accumulators, no TF32)
// and writes the operands' dtype; trans_b = 1 reads w as (n, k) row-major
// (the tied LM head's embedding table).
#include "gemm.cuh"
#include "gemm_splitk.cuh"
#include "gemm_wgmma.cuh"

using repro::FloatEpilogue;
using repro::launch_gemm;

namespace {

template <typename T, bool TB>
int by_tile(const void* x, const void* w, void* out, int m, int n, int k, int bm, int bn,
            int bk, const FloatEpilogue& epi, cudaStream_t s) {
  return launch_gemm<T, T, float, float, T, TB>(x, w, out, m, n, k, bm, bn, bk, epi, s);
}

template <typename T>
int by_route(int route, int trans_b, const void* x, const void* w, void* out, float* part,
             int m, int n, int k, int bm, int bn, int bk, int splits,
             const FloatEpilogue& epi, cudaStream_t s) {
  if (route == 0 && splits == 1)
    return trans_b ? by_tile<T, true>(x, w, out, m, n, k, bm, bn, bk, epi, s)
                   : by_tile<T, false>(x, w, out, m, n, k, bm, bn, bk, epi, s);
  if (route == 1)
    return repro::launch_splitk<T>(x, w, out, part, m, n, k, trans_b, bm, bn, bk, splits,
                                   epi, s);
  return REPRO_BAD_ARG;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it); route: 0 tile,
// 1 splitk, 2 wgmma; (bm, bn, bk, splits) the route's plan; workspace: the
// (splits, m, n) f32 partial sums of route 1 when splits > 1, else null.
extern "C" int matmul_fp_launch(const void* x, const void* w, const void* bias, void* out,
                                void* workspace, int m, int n, int k, int dtype, int trans_b,
                                int route, int bm, int bn, int bk, int splits, int relu,
                                int has_q, float qscale, float qlo, float qhi, int device,
                                void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return REPRO_BAD_ARG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FloatEpilogue epi{static_cast<const float*>(bias), relu, has_q, qscale, qlo, qhi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(workspace);
  if (dtype == 0)
    return by_route<float>(route, trans_b, x, w, out, part, m, n, k, bm, bn, bk, splits, epi,
                           s);
#ifndef REPRO_CPU_SHIM
  if (dtype == 1) {
    if (route == 2 && splits == 1)
      return repro::launch_wgmma(x, w, out, m, n, k, trans_b, bm, bn, bk, epi, s);
    return by_route<__nv_bfloat16>(route, trans_b, x, w, out, part, m, n, k, bm, bn, bk,
                                   splits, epi, s);
  }
#endif
  return REPRO_BAD_ARG;
}
