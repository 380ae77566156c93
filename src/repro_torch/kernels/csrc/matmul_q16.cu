// Fixed-point GEMM (int16 / int8 raws, mixed widths) with the fused
// bias << bias_shift -> ReLU -> shift_saturate epilogue, for sm_90a.
//
// Replaces repro/kernels/matmul_q16.py:matmul_q16_pallas (kernel
// _qmm_kernel).  The kernel body is gemm.cuh's; see there for the bound on
// this card.  Raws are widened to int32 in shared memory; the accumulator is
// a uint32_t, so it wraps mod 2^32 exactly as XLA's int32 dot does; the
// epilogue (common.cuh) writes the int16 or int8 rung, or the raw int32
// accumulator for the ``wide`` read-out of the classifier.
#include "gemm.cuh"

using repro::IntEpilogue;
using repro::launch_gemm;

namespace {

template <typename TX, typename TW>
int by_out(const void* x, const void* w, void* out, int obits, int m, int n, int k, int bm,
           int bn, int bk, const IntEpilogue& epi, cudaStream_t s) {
  if (obits == 16)
    return launch_gemm<TX, TW, int32_t, uint32_t, int16_t>(x, w, out, m, n, k, bm, bn, bk, epi,
                                                           s);
  if (obits == 8)
    return launch_gemm<TX, TW, int32_t, uint32_t, int8_t>(x, w, out, m, n, k, bm, bn, bk, epi,
                                                          s);
  if (obits == 32)
    return launch_gemm<TX, TW, int32_t, uint32_t, int32_t>(x, w, out, m, n, k, bm, bn, bk, epi,
                                                           s);
  return REPRO_BAD_ARG;
}

}  // namespace

// xbits / wbits: 8 or 16 (storage of the raws); obits: 8, 16, or 32 (wide).
extern "C" int matmul_q16_launch(const void* x, int xbits, const void* w, int wbits,
                                 const void* bias, void* out, int obits, int m, int n, int k,
                                 int bm, int bn, int bk, int relu, int shift, int bias_shift,
                                 int raw_min, int raw_max, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return REPRO_BAD_ARG;
  if (shift < -31 || shift > 31 || bias_shift < 0 || bias_shift > 31) return REPRO_BAD_ARG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const IntEpilogue epi{static_cast<const int32_t*>(bias), bias_shift, relu, shift, raw_min,
                        raw_max};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xbits == 16 && wbits == 16)
    return by_out<int16_t, int16_t>(x, w, out, obits, m, n, k, bm, bn, bk, epi, s);
  if (xbits == 16 && wbits == 8)
    return by_out<int16_t, int8_t>(x, w, out, obits, m, n, k, bm, bn, bk, epi, s);
  if (xbits == 8 && wbits == 16)
    return by_out<int8_t, int16_t>(x, w, out, obits, m, n, k, bm, bn, bk, epi, s);
  if (xbits == 8 && wbits == 8)
    return by_out<int8_t, int8_t>(x, w, out, obits, m, n, k, bm, bn, bk, epi, s);
  return REPRO_BAD_ARG;
}
