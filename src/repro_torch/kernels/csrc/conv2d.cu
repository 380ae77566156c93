// Direct NHWC convolution (implicit GEMM), float and fixed point, for sm_90a.
//
// Replaces repro/kernels/conv2d.py:conv2d_pallas (kernel _conv_kernel),
// conv2d_q16_pallas (kernel _conv_q16_kernel) and, through the same code,
// their manual-DMA regime _conv_dma_call (kernel _conv_dma_kernel), on two
// routes per numerics, which the planner (core/dse.py) picks from the shape:
//   "tc"       on the tensor cores: float convs whose Cin and Cout are
//              multiples of 8 in split-precision TF32 (conv2d_tc.cuh), and
//              fixed-point convs whose Cin·bytes is a multiple of 16 and
//              whose Cout is a multiple of 8 as s8 / u8 limb products,
//              bit-exact (conv2d_q16_tc.cuh); those headers say what bounds
//              them and what their designs do;
//   "cudacore" (conv_kernel below): the convs the tensor-core routes do not
//              take (Cin 1, 3 or 6: the zoo's first layers; LeNet's Cout 6),
//              float and fixed point, the integer sum bit-exact.
//
// conv_kernel: each block owns one output tile of (tile_rows x tile_cols)
// pixels of one image and a slice of tau output channels.  It walks its tile
// in passes of (sub_h x sub_w) pixels: for each Cin chunk it stages the
// pass's input window -- (sub_h-1)*stride + kh rows by (sub_w-1)*stride + kw
// columns, zero-filled outside the image, which stands in for the
// reference's pad -- and the kh*kw*chunk*tau weight slab in shared memory,
// then runs the K^2 taps as rank-1 updates into registers: each of the 256
// threads owns 4 pixels x 4 channels, so a pass covers 4096 / tau pixels.
// The fused epilogue (common.cuh) writes the pass back.
//
// Why this shape: the reference keeps a whole K^2*Cin*tau weight slab and a
// whole image slab resident in VMEM (64 MiB); a Hopper block has 227 KB of
// shared memory, and VGG16's 512-channel slab alone is 9.4 MB.  So Cin is
// split into chunks (an axis no Pallas regime has), and a block always loads
// exactly its own window: that is the reference's "dma" regime, and the
// untiled and two-block regimes are the same kernel with other tiles.  The
// float sum runs in another order than the reference (chunk, then tap); the
// integer sum is exact in any order.
//
// What bounds conv_kernel on an H100: its convs are bound by the CUDA cores
// (67 TFLOP/s f32; integer multiply-adds at about half that).  It feeds 16
// multiply-adds from 8 shared-memory loads, so shared-memory bandwidth caps
// it well below that peak.
#include "common.cuh"
#include "conv2d_q16_tc.cuh"
#include "conv2d_tc.cuh"

namespace repro {

struct ConvGeom {
  int n, h, w, cin;           // input, unpadded NHWC
  int kh, kw, stride, pad;
  int ho, wo, cout;
  int tau, chunk;             // output channels per block, Cin per staging step
  int tile_rows, tile_cols;   // the block's output tile
  int tiles_c;                // ceil(wo / tile_cols)
  int sub_h, sub_w;           // pixels per pass; sub_h * sub_w == 4096 / tau
};

// One input channel's window plane, padded to an odd length so that the
// channel-strided stores of the staging loop spread over the banks.
__host__ __device__ __forceinline__ int window_plane(int rows, int cols) {
  return rows * cols + (1 - (rows * cols) % 2);
}

template <typename TX, typename TW, typename TS, typename TA, typename TO, typename Epi>
__global__ void __launch_bounds__(256)
    conv_kernel(const TX* __restrict__ x, const TW* __restrict__ wt, TO* __restrict__ out,
                ConvGeom g, Epi epi) {
  DYN_SMEM(smem_raw);
  const int rows = (g.sub_h - 1) * g.stride + g.kh;
  const int cols = (g.sub_w - 1) * g.stride + g.kw;
  const int plane = window_plane(rows, cols);
  const int taps = g.kh * g.kw;
  TS* win = reinterpret_cast<TS*>(smem_raw);  // [chunk][plane]
  TS* wsm = win + plane * g.chunk;            // [taps][chunk][tau]

  const int tid = threadIdx.x;
  const int ct = g.tau / 4;  // channel groups of 4
  const int pt = 256 / ct;   // pixel groups
  const int cg = tid % ct, pg = tid / ct;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * g.tau;
  const int ty0 = (blockIdx.x / g.tiles_c) * g.tile_rows;
  const int tx0 = (blockIdx.x % g.tiles_c) * g.tile_cols;
  const int th = min(g.tile_rows, g.ho - ty0);
  const int tw = min(g.tile_cols, g.wo - tx0);

  // this thread's 4 pixels within a pass, and their offsets in the window
  int py[4], px[4], base[4];
  for (int q = 0; q < 4; ++q) {
    const int p = pg + q * pt;
    py[q] = p / g.sub_w;
    px[q] = p % g.sub_w;
    base[q] = py[q] * g.stride * cols + px[q] * g.stride;
  }
  const size_t img = static_cast<size_t>(b) * g.h * g.w * g.cin;

  for (int sy = 0; sy < th; sy += g.sub_h) {
    for (int sx = 0; sx < tw; sx += g.sub_w) {
      const int oy0 = ty0 + sy, ox0 = tx0 + sx;
      const int iy0 = oy0 * g.stride - g.pad, ix0 = ox0 * g.stride - g.pad;
      TA acc[4][4];
      for (int q = 0; q < 4; ++q)
        for (int r = 0; r < 4; ++r) acc[q][r] = TA(0);

      for (int c0 = 0; c0 < g.cin; c0 += g.chunk) {
        const int cc = min(g.chunk, g.cin - c0);
        __syncthreads();  // every read of the previous step's tiles is done
        const int nwin = rows * cols * cc;
        for (int idx = tid; idx < nwin; idx += 256) {
          const int c = idx % cc, rc = idx / cc;
          const int r = rc / cols, col = rc % cols;
          const int gy = iy0 + r, gx = ix0 + col;
          TS v = TS(0);
          if (gy >= 0 && gy < g.h && gx >= 0 && gx < g.w)
            v = static_cast<TS>(
                widen(x[img + (static_cast<size_t>(gy) * g.w + gx) * g.cin + c0 + c]));
          win[c * plane + r * cols + col] = v;
        }
        const int nw = taps * cc * g.tau;
        for (int idx = tid; idx < nw; idx += 256) {
          const int t = idx % g.tau, rest = idx / g.tau;
          const int c = rest % cc, tap = rest / cc;
          TS v = TS(0);
          if (t0 + t < g.cout)
            v = static_cast<TS>(
                widen(wt[(static_cast<size_t>(tap) * g.cin + c0 + c) * g.cout + t0 + t]));
          wsm[(tap * cc + c) * g.tau + t] = v;
        }
        __syncthreads();
        for (int c = 0; c < cc; ++c) {
          const TS* wc = win + c * plane;
          for (int i = 0; i < g.kh; ++i) {
            for (int j = 0; j < g.kw; ++j) {
              const int off = i * cols + j;
              const TS* wp = wsm + ((i * g.kw + j) * cc + c) * g.tau + cg * 4;
              TS a[4], bv[4];
              for (int q = 0; q < 4; ++q) a[q] = wc[base[q] + off];
              for (int r = 0; r < 4; ++r) bv[r] = wp[r];
              for (int q = 0; q < 4; ++q)
                for (int r = 0; r < 4; ++r) mac(acc[q][r], a[q], bv[r]);
            }
          }
        }
      }

      for (int q = 0; q < 4; ++q) {
        if (sy + py[q] >= th || sx + px[q] >= tw) continue;
        TO* o = out + ((static_cast<size_t>(b) * g.ho + oy0 + py[q]) * g.wo + ox0 + px[q]) *
                          g.cout;
        for (int r = 0; r < 4; ++r) {
          const int t = t0 + cg * 4 + r;
          if (t < g.cout) o[t] = epi.template apply<TO>(acc[q][r], t);
        }
      }
    }
  }
}

template <typename TX, typename TW, typename TS, typename TA, typename TO, typename Epi>
int launch_conv(const void* x, const void* w, void* out, const int* geom, Epi epi,
                int device, cudaStream_t stream) {
  const ConvGeom g{geom[0],  geom[1],  geom[2],  geom[3],  geom[4],  geom[5],
                   geom[6],  geom[7],  geom[8],  geom[9],  geom[10], geom[11],
                   geom[12], geom[13], geom[14], geom[15], geom[16], geom[17]};
  if (g.tau < 4 || g.tau % 4 != 0 || 256 % (g.tau / 4) != 0) return REPRO_BAD_ARG;
  if (g.sub_h * g.sub_w != 4096 / g.tau || g.chunk < 1 || g.stride < 1 || g.pad < 0)
    return REPRO_BAD_ARG;
  if (g.tile_rows < 1 || g.tile_cols < 1 || g.ho < 1 || g.wo < 1 || g.n < 1) return REPRO_BAD_ARG;
  if (g.tiles_c != (g.wo + g.tile_cols - 1) / g.tile_cols) return REPRO_BAD_ARG;
  const int rows = (g.sub_h - 1) * g.stride + g.kh;
  const int cols = (g.sub_w - 1) * g.stride + g.kw;
  const size_t smem =
      4 * (static_cast<size_t>(window_plane(rows, cols)) * g.chunk +
           static_cast<size_t>(g.kh) * g.kw * g.chunk * g.tau);
  if (smem > 232448) return REPRO_BAD_ARG;
  const int tiles_r = (g.ho + g.tile_rows - 1) / g.tile_rows;
  const dim3 grid(tiles_r * g.tiles_c, (g.cout + g.tau - 1) / g.tau, g.n);
  if (grid.y > 65535 || grid.z > 65535) return REPRO_BAD_ARG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kfn = conv_kernel<TX, TW, TS, TA, TO, Epi>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kfn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  LAUNCH(kfn, grid, dim3(256), smem, stream, static_cast<const TX*>(x),
         static_cast<const TW*>(w), static_cast<TO*>(out), g, epi);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int q16_by_out(const void* x, const void* w, void* out, int obits, const int* geom,
               const IntEpilogue& epi, int device, cudaStream_t s) {
  if (obits == 16)
    return launch_conv<TX, TW, int32_t, uint32_t, int16_t>(x, w, out, geom, epi, device, s);
  if (obits == 8)
    return launch_conv<TX, TW, int32_t, uint32_t, int8_t>(x, w, out, geom, epi, device, s);
  return REPRO_BAD_ARG;
}

}  // namespace repro

// geom: the 18 ints of repro::ConvGeom, in order.
extern "C" int conv2d_launch(const void* x, const void* w, const void* bias, void* out,
                             const int* geom, int relu, int has_q, float qscale, float qlo,
                             float qhi, int device, void* stream) {
  const repro::FloatEpilogue epi{static_cast<const float*>(bias), relu, has_q, qscale, qlo,
                                 qhi};
  return repro::launch_conv<float, float, float, float, float>(
      x, w, out, geom, epi, device, static_cast<cudaStream_t>(stream));
}

// The tensor-core route's weight preparation: w (K, K, Cin, Cout) f32 ->
// wp (2, Cout, K*K, Cin), its TF32 hi and lo planes.
extern "C" int conv2d_tc_prep_launch(const void* w, void* wp, int taps, int cin, int cout,
                                     int device, void* stream) {
#ifndef REPRO_CPU_SHIM
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return repro::launch_conv_tc_prep(w, wp, taps, cin, cout, static_cast<cudaStream_t>(stream));
#else
  return REPRO_BAD_ARG;  // inline PTX: no CPU counterpart
#endif
}

// The tensor-core route on x and the prepared wp; geom as for
// conv2d_launch, with chunk 32 and (sub_h, sub_w) the sub-tile of at most
// 128 pixels; workspace: the (splits, N*Ho*Wo, Cout) f32 partial sums when
// splits > 1, else null.
extern "C" int conv2d_tc_launch(const void* x, const void* wp, const void* bias, void* out,
                                void* workspace, const int* geom, int splits, int relu,
                                int has_q, float qscale, float qlo, float qhi, int device,
                                void* stream) {
#ifndef REPRO_CPU_SHIM
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const repro::FloatEpilogue epi{static_cast<const float*>(bias), relu, has_q, qscale, qlo,
                                 qhi};
  return repro::launch_conv_tc(x, wp, out, static_cast<float*>(workspace), geom, splits, epi,
                               static_cast<cudaStream_t>(stream));
#else
  return REPRO_BAD_ARG;  // inline PTX: no CPU counterpart
#endif
}

// xbits / wbits: 8 or 16; obits: 8 or 16.
extern "C" int conv2d_q16_launch(const void* x, int xbits, const void* w, int wbits,
                                 const void* bias, void* out, int obits, const int* geom,
                                 int relu, int shift, int bias_shift, int raw_min, int raw_max,
                                 int device, void* stream) {
  if (shift < -31 || shift > 31 || bias_shift < 0 || bias_shift > 31) return REPRO_BAD_ARG;
  const repro::IntEpilogue epi{static_cast<const int32_t*>(bias), bias_shift, relu, shift,
                               raw_min, raw_max};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xbits == 16 && wbits == 16)
    return repro::q16_by_out<int16_t, int16_t>(x, w, out, obits, geom, epi, device, s);
  if (xbits == 16 && wbits == 8)
    return repro::q16_by_out<int16_t, int8_t>(x, w, out, obits, geom, epi, device, s);
  if (xbits == 8 && wbits == 16)
    return repro::q16_by_out<int8_t, int16_t>(x, w, out, obits, geom, epi, device, s);
  if (xbits == 8 && wbits == 8)
    return repro::q16_by_out<int8_t, int8_t>(x, w, out, obits, geom, epi, device, s);
  return REPRO_BAD_ARG;
}

// The fixed-point tensor-core route's weight preparation: w (K, K, Cin,
// Cout) raws of wbits (8 or 16) -> wp (limbs, Cout, K*K, cinp) bytes, the
// signed hi and unsigned lo bytes of int16 (one plane for int8), Cin
// zero-padded to cinp, the next multiple of 64.
extern "C" int conv2d_q16_tc_prep_launch(const void* w, int wbits, void* wp, int taps, int cin,
                                         int cout, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return repro::launch_conv_q16_tc_prep(w, wbits, wp, taps, cin, cout,
                                        static_cast<cudaStream_t>(stream));
}

// The fixed-point tensor-core route on x (NHWC raws of xbits) and the
// prepared wp (of wbits); geom as for conv2d_launch, with chunk 64 and
// (sub_h, sub_w) the sub-tile of at most 128 pixels; out on the rung of
// obits (8 or 16); workspace: the (splits, N*Ho*Wo, Cout) int32 partial sums
// when splits > 1, else null.
extern "C" int conv2d_q16_tc_launch(const void* x, int xbits, const void* wp, int wbits,
                                    const void* bias, void* out, int obits, void* workspace,
                                    const int* geom, int splits, int relu, int shift,
                                    int bias_shift, int raw_min, int raw_max, int device,
                                    void* stream) {
#ifndef REPRO_CPU_SHIM
  if (shift < -31 || shift > 31 || bias_shift < 0 || bias_shift > 31) return REPRO_BAD_ARG;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const repro::IntRungEpilogue epi{
      {static_cast<const int32_t*>(bias), bias_shift, relu, shift, raw_min, raw_max}, obits};
  return repro::launch_conv_q16_tc(x, xbits, wp, wbits, out, static_cast<uint32_t*>(workspace),
                                   geom, splits, epi, static_cast<cudaStream_t>(stream));
#else
  return REPRO_BAD_ARG;  // inline PTX: no CPU counterpart
#endif
}
