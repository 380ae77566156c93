// The block-tiled GEMM: route "tile" (L) of matmul_fp.cu and of
// matmul_q16.cu.
//
// Replaces the TPU kernels repro/kernels/matmul_fp.py:_mm_kernel (via
// matmul_fp_pallas) and repro/kernels/matmul_q16.py:_qmm_kernel (via
// matmul_q16_pallas).  On the TPU the grid walks k sequentially with the
// accumulator in VMEM scratch; here one block owns a (BM, BN) output tile
// and loops over k itself, keeping the accumulator in registers, and runs
// the fused epilogue of common.cuh on its last step.
//
// What bounds it on an H100: with large m (the im2col route) the CUDA
// cores, 67 TFLOP/s f32 (integer multiply-adds at about half that rate);
// with batch-8 m the weight read, 3.35 TB/s.  This kernel is plain: each
// k-step stages an x tile and a w tile in shared memory (widened to 4
// bytes), and each of the 256 threads accumulates a TM x TN register tile
// on CUDA cores.  The float GEMM takes it only for f32 with m > 16 (f32
// stays f32: the reference holds it at 1e-4, which TF32 misses) and for
// bf16 shapes that TMA cannot address; bf16 with large m runs on the
// tensor cores (gemm_wgmma.cuh) and every m <= 16 on the split-k stream
// (gemm_splitk.cuh).  The fixed-point GEMM takes it only when a plan names
// it: its raws run on the split-k stream for m <= 16 and on the int8 tensor
// cores as signed / unsigned byte limbs above (gemm_q16_wgmma.cuh).
//
// TB (transposed B) reads w as an (n, k) row-major matrix: the tied LM head
// multiplies by the (vocab, d) embedding table as it is stored, so no
// transposed copy of the model's largest tensor is ever made.  Its w tile
// is loaded along k and its shared-memory rows are padded by one element, so
// the transposing store does not hit one bank.
#pragma once

#include "common.cuh"

namespace repro {

template <typename TX, typename TW, typename TS, typename TA, typename TO, typename Epi,
          int BM, int BN, int BK, int TM, int TN, bool TB>
__global__ void __launch_bounds__(256)
    gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TO* __restrict__ out,
                int m, int n, int k, Epi epi) {
  static_assert((BM / TM) * (BN / TN) == 256, "256 threads per block");
  __shared__ TS xs[BK][BM];  // x tile, transposed: xs[kk][row]
  __shared__ TS ws[BK][BN + (TB ? 1 : 0)];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  // m tiles run along x (no 65535 cap) and neighbouring blocks share a w tile
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  TA acc[TM][TN];
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < TN; ++j) acc[i][j] = TA(0);

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += 256) {
      const int r = idx / BK, c = idx % BK;
      const int gr = m0 + r, gc = k0 + c;
      TS v = TS(0);
      if (gr < m && gc < k) v = static_cast<TS>(widen(x[static_cast<size_t>(gr) * k + gc]));
      xs[c][r] = v;
    }
    for (int idx = tid; idx < BK * BN; idx += 256) {
      const int r = TB ? idx % BK : idx / BN, c = TB ? idx / BK : idx % BN;
      const int gr = k0 + r, gc = n0 + c;
      TS v = TS(0);
      if (gr < k && gc < n)
        v = static_cast<TS>(widen(TB ? w[static_cast<size_t>(gc) * k + gr]
                                     : w[static_cast<size_t>(gr) * n + gc]));
      ws[r][c] = v;
    }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      TS a[TM], b[TN];
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
      for (int i = 0; i < TM; ++i)
        for (int j = 0; j < TN; ++j) mac(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= m) continue;
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < n) out[static_cast<size_t>(r) * n + c] = epi.template apply<TO>(acc[i][j], c);
    }
  }
}

// Launch one of the compiled tiles; returns cudaGetLastError() or
// REPRO_BAD_ARG for a tile that was not compiled.
template <typename TX, typename TW, typename TS, typename TA, typename TO, bool TB = false,
          typename Epi>
int launch_gemm(const void* x, const void* w, void* out, int m, int n, int k, int bm, int bn,
                int bk, Epi epi, cudaStream_t stream) {
  const dim3 block(256);
  if ((n + 15) / 16 > 65535) return REPRO_BAD_ARG;
  if (bm == 16 && bn == 64 && bk == 16) {
    const dim3 grid((m + 15) / 16, (n + 63) / 64);
    auto kfn = gemm_kernel<TX, TW, TS, TA, TO, Epi, 16, 64, 16, 1, 4, TB>;
    LAUNCH(kfn, grid, block, 0, stream,
           static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TO*>(out), m, n,
           k, epi);
  } else if (bm == 64 && bn == 64 && bk == 16) {
    const dim3 grid((m + 63) / 64, (n + 63) / 64);
    auto kfn = gemm_kernel<TX, TW, TS, TA, TO, Epi, 64, 64, 16, 4, 4, TB>;
    LAUNCH(kfn, grid, block, 0, stream,
           static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TO*>(out), m, n,
           k, epi);
  } else if (bm == 128 && bn == 128 && bk == 16) {
    const dim3 grid((m + 127) / 128, (n + 127) / 128);
    auto kfn = gemm_kernel<TX, TW, TS, TA, TO, Epi, 128, 128, 16, 8, 8, TB>;
    LAUNCH(kfn, grid, block, 0, stream,
           static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TO*>(out), m, n,
           k, epi);
  } else {
    return REPRO_BAD_ARG;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
