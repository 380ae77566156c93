// Fixed-point GEMM (int16 / int8 raws, mixed widths) with the fused
// bias << bias_shift -> ReLU -> shift_saturate epilogue, for sm_90a.
//
// Replaces repro/kernels/matmul_q16.py:matmul_q16_pallas (kernel
// _qmm_kernel) on three routes, which the planner
// (core/dse.py:default_q16_block_for) picks from m; each header says what
// bounds its route on this card and what its design does about that:
//   route 0, "tile"   (gemm.cuh): the block-tiled CUDA-core GEMM, raws
//                     widened to int32 in shared memory; taken only when a
//                     plan names it;
//   route 1, "splitk" (gemm_splitk.cuh): m <= 16, w streamed once over k
//                     slices (the CNNs' FC layers, decode, the LM head);
//   route 2, "wgmma"  (gemm_q16_wgmma.cuh): every larger m on the int8
//                     tensor cores, each int16 operand as a signed high and
//                     an unsigned low byte, after a preparation launch that
//                     writes the byte planes (matmul_q16_prep_launch).
// Every route accumulates mod 2^32 exactly as XLA's int32 dot does (a
// uint32_t on the CUDA cores, s32 wgmma accumulators without .satfinite,
// recombined in uint32_t) and runs common.cuh's IntEpilogue: the int16 or
// int8 rung, or the raw int32 accumulator for the ``wide`` read-out.
#include "gemm.cuh"
#include "gemm_q16_wgmma.cuh"
#include "gemm_splitk.cuh"

using repro::IntEpilogue;
using repro::IntRungEpilogue;
using repro::launch_gemm;

namespace {

// Route 0 is compiled per output rung, route 1 once (its rung is chosen at
// run time).
template <typename TX, typename TW>
int by_route(int route, const void* x, const void* w, void* out, int obits, uint32_t* part,
             int m, int n, int k, int bm, int bn, int bk, int splits, const IntEpilogue& epi,
             cudaStream_t s) {
  if (obits != 8 && obits != 16 && obits != 32) return REPRO_BAD_ARG;
  if (route == 1)
    return repro::launch_splitk<TX, TW, void, IntRungEpilogue>(
        x, w, out, part, m, n, k, 0, bm, bn, bk, splits, IntRungEpilogue{epi, obits}, s);
  if (route != 0 || splits != 1) return REPRO_BAD_ARG;
  if (obits == 16)
    return launch_gemm<TX, TW, int32_t, uint32_t, int16_t>(x, w, out, m, n, k, bm, bn, bk,
                                                           epi, s);
  if (obits == 8)
    return launch_gemm<TX, TW, int32_t, uint32_t, int8_t>(x, w, out, m, n, k, bm, bn, bk, epi,
                                                          s);
  return launch_gemm<TX, TW, int32_t, uint32_t, int32_t>(x, w, out, m, n, k, bm, bn, bk, epi,
                                                         s);
}

bool bad_epilogue(int shift, int bias_shift) {
  return shift < -31 || shift > 31 || bias_shift < 0 || bias_shift > 31;
}

}  // namespace

// Routes 0 and 1.  xbits / wbits: 8 or 16 (storage of the raws); obits: 8,
// 16, or 32 (wide); route: 0 tile, 1 splitk; (bm, bn, bk, splits) the
// route's plan; workspace: the (splits, m, n) uint32_t partial sums of
// route 1 when splits > 1, else null.
extern "C" int matmul_q16_launch(const void* x, int xbits, const void* w, int wbits,
                                 const void* bias, void* out, int obits, void* workspace,
                                 int m, int n, int k, int route, int bm, int bn, int bk,
                                 int splits, int relu, int shift, int bias_shift, int raw_min,
                                 int raw_max, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return REPRO_BAD_ARG;
  if (bad_epilogue(shift, bias_shift)) return REPRO_BAD_ARG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const IntEpilogue epi{static_cast<const int32_t*>(bias), bias_shift, relu, shift, raw_min,
                        raw_max};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* part = static_cast<uint32_t*>(workspace);
  if (xbits == 16 && wbits == 16)
    return by_route<int16_t, int16_t>(route, x, w, out, obits, part, m, n, k, bm, bn, bk,
                                      splits, epi, s);
  if (xbits == 16 && wbits == 8)
    return by_route<int16_t, int8_t>(route, x, w, out, obits, part, m, n, k, bm, bn, bk,
                                     splits, epi, s);
  if (xbits == 8 && wbits == 16)
    return by_route<int8_t, int16_t>(route, x, w, out, obits, part, m, n, k, bm, bn, bk,
                                     splits, epi, s);
  if (xbits == 8 && wbits == 8)
    return by_route<int8_t, int8_t>(route, x, w, out, obits, part, m, n, k, bm, bn, bk,
                                    splits, epi, s);
  return REPRO_BAD_ARG;
}

// Route 2's preparation: x (m, k) and w (k, n) into byte planes xplanes
// (limbs, m, kp), null when an int8 x with 16-byte rows is read in place,
// and wplanes (limbs, n, kp), with zeros from k to kp.
extern "C" int matmul_q16_prep_launch(const void* x, int xbits, const void* w, int wbits,
                                      void* xplanes, void* wplanes, int m, int n, int k,
                                      int kp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return repro::launch_q16_prep(x, xbits, w, wbits, xplanes, wplanes, m, n, k, kp,
                                static_cast<cudaStream_t>(stream));
}

// Route 2 on the prepared planes (x_in_place: xsrc is the int8 x itself).
extern "C" int matmul_q16_wgmma_launch(const void* xsrc, int xbits, int x_in_place,
                                       const void* wplanes, int wbits, const void* bias,
                                       void* out, int obits, int m, int n, int k, int kp,
                                       int bm, int bn, int bk, int relu, int shift,
                                       int bias_shift, int raw_min, int raw_max, int device,
                                       void* stream) {
#ifdef REPRO_CPU_SHIM
  return REPRO_BAD_ARG;  // inline PTX for sm_90a: no CPU counterpart
#else
  if (bad_epilogue(shift, bias_shift)) return REPRO_BAD_ARG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const IntEpilogue epi{static_cast<const int32_t*>(bias), bias_shift, relu, shift, raw_min,
                        raw_max};
  return repro::launch_q16_wgmma(xsrc, xbits, x_in_place, wplanes, wbits, out, m, n, k, kp, bm,
                                 bn, bk, IntRungEpilogue{epi, obits},
                                 static_cast<cudaStream_t>(stream));
#endif
}
