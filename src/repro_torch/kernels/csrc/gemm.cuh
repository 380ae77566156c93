// The block-tiled GEMM shared by matmul_fp.cu and matmul_q16.cu.
//
// Replaces the TPU kernels repro/kernels/matmul_fp.py:_mm_kernel (via
// matmul_fp_pallas) and repro/kernels/matmul_q16.py:_qmm_kernel (via
// matmul_q16_pallas).  On the TPU the grid walks k sequentially with the
// accumulator in VMEM scratch; here one block owns a (BM, BN) output tile
// and loops over k itself, keeping the accumulator in registers, and runs
// the fused epilogue of common.cuh on its last step.
//
// What bounds it on an H100: the zoo's FC layers run at batch 8, so m is
// tiny and the weight matrix (VGG16 fc0: 25088 x 4096, 411 MB in f32) is
// read once from HBM: memory bound, 3.35 TB/s.  The im2col route has large
// m and is bound by the CUDA cores (67 TFLOP/s f32; integer multiply-adds
// run at about half that rate).  This first version is plain: each k-step
// stages an x tile and a w tile in shared memory (widened to 4 bytes), and
// each of the 256 threads accumulates a TM x TN register tile on CUDA
// cores.  The small (16, 64) tile exists so that batch-8 FC layers spread
// the weight read over more blocks.  No tensor cores: f32 stays f32 (the
// reference holds it at 1e-4, which TF32 misses) and int16 has no MMA.
#pragma once

#include "common.cuh"

namespace repro {

template <typename TX, typename TW, typename TS, typename TA, typename TO, typename Epi,
          int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(256)
    gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TO* __restrict__ out,
                int m, int n, int k, Epi epi) {
  static_assert((BM / TM) * (BN / TN) == 256, "256 threads per block");
  __shared__ TS xs[BK][BM];  // x tile, transposed: xs[kk][row]
  __shared__ TS ws[BK][BN];
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
      const int r = idx / BN, c = idx % BN;
      const int gr = k0 + r, gc = n0 + c;
      TS v = TS(0);
      if (gr < k && gc < n) v = static_cast<TS>(widen(w[static_cast<size_t>(gr) * n + gc]));
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
template <typename TX, typename TW, typename TS, typename TA, typename TO, typename Epi>
int launch_gemm(const void* x, const void* w, void* out, int m, int n, int k, int bm, int bn,
                int bk, Epi epi, cudaStream_t stream) {
  const dim3 block(256);
  if ((n + 15) / 16 > 65535) return REPRO_BAD_ARG;
  if (bm == 16 && bn == 64 && bk == 16) {
    const dim3 grid((m + 15) / 16, (n + 63) / 64);
    auto kfn = gemm_kernel<TX, TW, TS, TA, TO, Epi, 16, 64, 16, 1, 4>;
    LAUNCH(kfn, grid, block, 0, stream,
           static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TO*>(out), m, n,
           k, epi);
  } else if (bm == 64 && bn == 64 && bk == 16) {
    const dim3 grid((m + 63) / 64, (n + 63) / 64);
    auto kfn = gemm_kernel<TX, TW, TS, TA, TO, Epi, 64, 64, 16, 4, 4>;
    LAUNCH(kfn, grid, block, 0, stream,
           static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TO*>(out), m, n,
           k, epi);
  } else if (bm == 128 && bn == 128 && bk == 16) {
    const dim3 grid((m + 127) / 128, (n + 127) / 128);
    auto kfn = gemm_kernel<TX, TW, TS, TA, TO, Epi, 128, 128, 16, 8, 8>;
    LAUNCH(kfn, grid, block, 0, stream,
           static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TO*>(out), m, n,
           k, epi);
  } else {
    return REPRO_BAD_ARG;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
