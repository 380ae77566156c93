// Tensor-core route of the float direct conv: an implicit GEMM on wgmma in
// split-precision TF32 (3xTF32), for sm_90a.
//
// Replaces, with conv2d.cu's CUDA-core conv_kernel, the TPU kernel
// repro/kernels/conv2d.py:conv2d_pallas (kernel _conv_kernel) and, through
// the same code, its manual-DMA regime _conv_dma_call (_conv_dma_kernel),
// for every float conv whose Cin and Cout are multiples of 8 and for which
// a sub-tile's input window fits shared memory and TMA's box (VGG16
// conv1-12, AlexNet conv1-4); the planner (core/dse.py) sends the others,
// and every fixed-point conv, to conv_kernel.
//
// What bounds it on an H100: VGG16's convs reuse each input 9·Cout times and
// each weight N·Ho·Wo times, so operations bound them, not bytes.  f32 on
// the CUDA cores peaks at 67 TFLOP/s; the tensor cores take f32-class
// operands only as TF32 (495 TFLOP/s dense), whose 11 significant bits miss
// the reference's 1e-4.  So each operand is split, x = hi + lo with hi the
// TF32 rounding of x (cvt.rna: nearest, ties away from zero) and lo the
// TF32 rounding of x - hi (rounded the same way, not truncated), and each
// product is issued as three TF32 products into one f32 accumulator:
// hi·lo, lo·hi, then hi·hi.  The dropped lo·lo term and lo's rounding are
// ~2^-22 of the product: f32-class accuracy at 3 x 2·N·Ho·Wo·Cout·K²·Cin
// tensor-core operations (VGG16 conv1: 0.179 ms of them, against 0.442 ms
// on the CUDA cores).
//
// The design:
//   * GEMM view: M = output pixels of a sub-tile (BM = 128: two consumer
//     warpgroups of 64 rows), N = a slice of τ output channels (64 or 128),
//     K = taps x Cin, walked as (Cin chunk of 32, tap) steps; a block owns an
//     output region (the plan's tile, or one sub-tile) and one τ slice, and
//     walks the region's sub-tiles of sub_h x sub_w <= 128 pixels;
//   * staging: one producer thread keeps two rings full with TMA.  The
//     input window of a sub-tile and chunk -- (sub_h-1)·stride+kh rows by
//     (sub_w-1)·stride+kw columns of 32 channels -- is one box of a 4-D
//     tensor map over NHWC x; coordinates left of or past the image are
//     filled with zeros by TMA, which is the pad.  The weight slab of a
//     (chunk, tap) step is one box of a 4-D map over the prepared weights
//     (both planes at once); each ring slot has a full mbarrier (TMA's bytes
//     land there) and an empty one (each consumer warp arrives when it has
//     finished with the slot), so loads run ahead of math;
//   * operands: TF32 wgmma takes only K-major operands (the transpose flag
//     exists for f16 / bf16 alone).  A is the pixels: a pixel's channels
//     are contiguous in NHWC, and each tap's shift is an offset into the
//     staged window, so no im2col copy is made: each thread reads its A
//     fragment for the tap from shared memory (128-byte swizzled rows, so
//     the 8 pixels of a fragment column hit 8 different bank groups), splits
//     it into hi / lo in registers, and issues register-A wgmma.  B is the
//     weights, which the port keeps as (K, K, Cin, Cout), N-major: a
//     preparation pass per call (conv_tc_prep) writes them as
//     (2, Cout, K·K, Cin), K-major, split into the hi and lo planes;
//   * pipelining: while one step's 12 wgmmas (4 k-steps of 8 x 3 products)
//     run, the next step's window values load into plain registers; they
//     are split into the A operand registers only after the running group
//     has been waited for (a register-A wgmma reads its registers until
//     then; writing them earlier gave wrong sums on the card), and the
//     other consumer warpgroup's wgmmas fill that gap;
//   * a Cin split: when the grid has too few blocks for the 132 SMs (VGG16's
//     14² layers), blocks also split the Cin chunks; each writes f32 partial
//     sums to a (splits, N·Ho·Wo, Cout) workspace and common.cuh's
//     split_reduce_kernel adds them in split order and runs the epilogue.
//     No atomics: a forward is the same bits on every run;
//   * accumulation: the tensor cores' f32 accumulator truncates its adds
//     (measured on the card: VGG16 conv8's 4608-deep sums drifted by ~1e-4
//     of |y| when one accumulator took all 1728 wgmmas), so each chunk's
//     wgmmas (3 x 4 x K² of them) start from zero and the chunk's result is
//     added to the sub-tile's f32 sum on the CUDA cores, rounded to nearest;
//   * epilogue: common.cuh's FloatEpilogue (bias, ReLU, fake-quant) on the
//     summed registers, stored as float pairs straight to NHWC.
// TMA needs 16-byte row strides and bases: Cin and Cout multiples of 8 and
// 16-byte aligned operands, which the planner and the wrapper enforce; the
// launcher refuses anything else.
//
// All of it is inline PTX for sm_90a, so none of it exists under the CPU
// shim (REPRO_CPU_SHIM): the CPU tests cannot run this route.
#pragma once

#ifndef REPRO_CPU_SHIM
#include "hopper.cuh"

namespace repro {
namespace convtc {

using namespace hopper;

constexpr int BM = 128;            // pixels of a sub-tile: two consumer warpgroups of 64
constexpr int CHUNK = 32;          // Cin per step: 32 f32 = one 128-byte swizzle row
constexpr int KSTEPS = CHUNK / 8;  // TF32 wgmma k-steps of a chunk
constexpr int THREADS = 384;       // producer warpgroup + two consumer warpgroups
constexpr int WIN_STAGES = 2;      // input windows in flight
constexpr int MAX_BOX = 256;       // TMA's largest box extent
constexpr int SMEM_LIMIT = 232448;

// weight ring: 128 KB at τ 128, 96 KB at τ 64, beside two windows
template <int TAU>
__host__ __device__ constexpr int w_stages() {
  return TAU == 128 ? 4 : 6;
}
template <int TAU>
__host__ __device__ constexpr int w_slot() {
  return 2 * TAU * CHUNK * 4;  // the hi and lo planes of one (chunk, tap) step
}
__host__ __device__ inline int win_slot(int rows, int cols) {
  return (rows * cols * CHUNK * 4 + 1023) & ~1023;  // swizzle atoms are 1024 bytes
}
template <int TAU>
__host__ __device__ inline int smem_bytes(int win_rows, int win_cols) {
  // alignment slack, the weight ring, the windows, the barriers
  return 1024 + w_stages<TAU>() * w_slot<TAU>() + WIN_STAGES * win_slot(win_rows, win_cols) +
         (2 * WIN_STAGES + 2 * w_stages<TAU>()) * 8;
}

// round to the nearest TF32 (10 mantissa bits), ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (what rounding lo drops): both halves rounded, none truncated
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// D (64 x 64, f32 in registers) += A (64 x 8, TF32 in registers) . B (8 x 64,
// TF32 from shared memory, K-major, through its descriptor).
__device__ __forceinline__ void mma_m64n64k8(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32 in registers) += A (64 x 8, TF32 in registers) . B (8 x 128,
// TF32 from shared memory, K-major, through its descriptor).
__device__ __forceinline__ void mma_m64n128k8(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int TAU>
__device__ __forceinline__ void mma(float (&d)[TAU / 2], const uint32_t* a, uint64_t db) {
  if constexpr (TAU == 128) {
    mma_m64n128k8(d, a, db);
  } else {
    mma_m64n64k8(d, a, db);
  }
}

// Channel ch of window pixel q: the box's rows are 128 bytes (32 channels),
// and TMA's 128-byte swizzle moves 16-byte chunk c of row q to c ^ (q % 8).
__device__ __forceinline__ float win_at(const unsigned char* win, int q, int chunk16, int tq) {
  return *reinterpret_cast<const float*>(win + q * 128 + ((chunk16 ^ (q & 7)) << 4) + tq * 4);
}

// Rows q0 and q1 (g and g + 8 of the warp's 16) of a step's A fragments,
// read from the window: layout of m64nNk8 TF32 A, a0 (row g, k tq), a1 (row
// g + 8, k tq), a2 (row g, k tq + 4), a3 (row g + 8, k tq + 4), g = lane / 4,
// tq = lane % 4, for each k-step of 8 channels.
__device__ __forceinline__ void load_a(float (&xr)[4 * KSTEPS], const unsigned char* win,
                                       int q0, int q1, int tq) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    xr[4 * kk] = win_at(win, q0, 2 * kk, tq);
    xr[4 * kk + 1] = win_at(win, q1, 2 * kk, tq);
    xr[4 * kk + 2] = win_at(win, q0, 2 * kk + 1, tq);
    xr[4 * kk + 3] = win_at(win, q1, 2 * kk + 1, tq);
  }
}

// One (chunk, tap) step of a consumer warpgroup: its A fragments split into
// hi / lo, then 4 k-steps of hi·lo, lo·hi, hi·hi, committed as one group.
// The registers hi and lo are wgmma operands until that group is waited for.
template <int TAU>
__device__ __forceinline__ void issue(float (&acc)[TAU / 2], const float (&xr)[4 * KSTEPS],
                                      uint32_t (&hi)[4 * KSTEPS], uint32_t (&lo)[4 * KSTEPS],
                                      const unsigned char* slab) {
#pragma unroll
  for (int i = 0; i < 4 * KSTEPS; ++i) split_tf32(xr[i], hi[i], lo[i]);
  // B planes: TAU rows of 128 bytes each, K-major, 8-row groups 1024 bytes
  // apart; a k-step of 8 TF32 is 32 bytes on (2 in descriptor units)
  const uint64_t dhi = smem_desc(slab, 16, 1024);
  const uint64_t dlo = smem_desc(slab + TAU * CHUNK * 4, 16, 1024);
  fence_regs(acc);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    mma<TAU>(acc, hi + 4 * kk, dlo + 2 * kk);
    mma<TAU>(acc, lo + 4 * kk, dhi + 2 * kk);
    mma<TAU>(acc, hi + 4 * kk, dhi + 2 * kk);
  }
  wgmma_commit();
}


struct TcArgs {
  int n, h, w, cin, kh, kw, stride, pad, ho, wo, cout;
  int tile_rows, tile_cols, tiles_r, tiles_c;  // each block's output region
  int sub_h, sub_w;                            // a sub-tile: sub_h·sub_w <= BM pixels
  int win_rows, win_cols;                      // its input window
  int chunks, per_split;                       // Cin chunks; chunks of one split
};

// A sub-tile's write-back.  Accumulator layout of m64nN: register 4j + 2h +
// e holds row 16·warp + g + 8h, column 8j + 2·tq + e.  One split: the NHWC
// output through the epilogue; several: split blockIdx.z's plane of the
// (splits, N·Ho·Wo, Cout) workspace, raw.
template <int TAU>
__device__ __forceinline__ void tile_epilogue(const float (&acc)[TAU / 2], const TcArgs& a,
                                              float* out, const FloatEpilogue& epi, int b,
                                              int ry0, int rx0, int rh, int rw, int n0, int st,
                                              int nsx, int p0, int tq) {
  const int oy0 = ry0 + (st / nsx) * a.sub_h, ox0 = rx0 + (st % nsx) * a.sub_w;
  const bool raw_sums = gridDim.z > 1;
  float* dst =
      out + (raw_sums ? static_cast<size_t>(blockIdx.z) * a.n * a.ho * a.wo * a.cout : 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + 8 * h;
    const int oy = oy0 + p / a.sub_w, ox = ox0 + p % a.sub_w;
    if (p >= a.sub_h * a.sub_w || oy >= ry0 + rh || ox >= rx0 + rw) continue;
    float* o = dst + ((static_cast<size_t>(b) * a.ho + oy) * a.wo + ox) * a.cout;
#pragma unroll
    for (int j = 0; j < TAU / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      if (col >= a.cout) continue;  // Cout % 8 == 0: col + 1 exists too
      float2 r;
      r.x = acc[4 * j + 2 * h];
      r.y = acc[4 * j + 2 * h + 1];
      if (!raw_sums) {
        r.x = epi.template apply<float>(r.x, col);
        r.y = epi.template apply<float>(r.y, col + 1);
      }
      *reinterpret_cast<float2*>(o + col) = r;
    }
  }
}

// Grid: (N · regions, Cout / τ, splits).  splits == 1: ``out`` is the NHWC
// output, written through the epilogue; else the (splits, N·Ho·Wo, Cout)
// workspace, written raw.
template <int TAU>
__global__ void __launch_bounds__(THREADS, 1)
    conv_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w, TcArgs a, float* __restrict__ out,
                   FloatEpilogue epi) {
  constexpr int S = w_stages<TAU>();
  constexpr int W_SLOT = w_slot<TAU>();
  const int WIN = win_slot(a.win_rows, a.win_cols);
  DYN_SMEM(raw);
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = base;
  unsigned char* wins = base + S * W_SLOT;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(wins + WIN_STAGES * WIN);
  uint64_t* w_empty = w_full + S;
  uint64_t* win_full = w_empty + S;
  uint64_t* win_empty = win_full + WIN_STAGES;

  const int taps = a.kh * a.kw;
  const int regions = a.tiles_r * a.tiles_c;
  const int b = blockIdx.x / regions;
  const int rg = blockIdx.x % regions;
  const int ry0 = (rg / a.tiles_c) * a.tile_rows, rx0 = (rg % a.tiles_c) * a.tile_cols;
  const int rh = min(a.tile_rows, a.ho - ry0), rw = min(a.tile_cols, a.wo - rx0);
  const int nsx = (rw + a.sub_w - 1) / a.sub_w;
  const int subtiles = ((rh + a.sub_h - 1) / a.sub_h) * nsx;
  const int n0 = blockIdx.y * TAU;
  const int c_lo = blockIdx.z * a.per_split;
  const int c_hi = min(a.chunks, c_lo + a.per_split);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], 8);  // every consumer warp
    }
    for (int i = 0; i < WIN_STAGES; ++i) {
      mbar_init(&win_full[i], 1);
      mbar_init(&win_empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer warpgroup: one thread keeps both rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const uint32_t win_bytes = a.win_rows * a.win_cols * CHUNK * 4;
      int s = 0, sp = 0, v = 0, vp = 0;
      for (int st = 0; st < subtiles; ++st) {
        const int oy = ry0 + (st / nsx) * a.sub_h, ox = rx0 + (st % nsx) * a.sub_w;
        const int iy = oy * a.stride - a.pad, ix = ox * a.stride - a.pad;
        for (int c = c_lo; c < c_hi; ++c) {
          mbar_wait(&win_empty[v], vp ^ 1);
          mbar_expect_tx(&win_full[v], win_bytes);
          tma_load_4d(wins + v * WIN, &map_x, &win_full[v], c * CHUNK, ix, iy, b);
          if (++v == WIN_STAGES) {
            v = 0;
            vp ^= 1;
          }
          for (int t = 0; t < taps; ++t) {
            mbar_wait(&w_empty[s], sp ^ 1);
            mbar_expect_tx(&w_full[s], W_SLOT);
            tma_load_4d(ring + s * W_SLOT, &map_w, &w_full[s], c * CHUNK, t, n0, 0);
            if (++s == S) {
              s = 0;
              sp ^= 1;
            }
          }
        }
      }
    }
  } else {
    // consumer warpgroups: rows 64 (wg - 1) .. 64 wg - 1 of each sub-tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int half = wg - 1;
    const int t128 = threadIdx.x % 128;
    const int lane = t128 % 32;
    const int g = lane / 4, tq = lane % 4;
    const int pix = a.sub_h * a.sub_w;
    // this thread's rows (h = 0, 1) of the sub-tile, and their window pixel
    // at tap (0, 0); rows past the sub-tile read pixel 0 and are not stored
    const int p0 = half * 64 + (t128 / 32) * 16 + g;
    int qb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 8 * h < pix ? p0 + 8 * h : 0;
      qb[h] = (p / a.sub_w) * a.stride * a.win_cols + (p % a.sub_w) * a.stride;
    }
    // The steps (sub-tile, chunk, tap) in order.  While a step's wgmmas run,
    // the next step's window values load into xr; they become wgmma
    // operands (hi, lo) only after the running group has been waited for,
    // since a register-A wgmma reads its registers until then.
    // acc: the wgmma accumulator of the current chunk; sum: the sub-tile's
    // total, to which each chunk's acc is added on the CUDA cores
    float acc[TAU / 2], sum[TAU / 2];
    float xr[4 * KSTEPS];
    uint32_t hi[4 * KSTEPS], lo[4 * KSTEPS];
#pragma unroll
    for (int i = 0; i < TAU / 2; ++i) acc[i] = sum[i] = 0.0f;
    int st = 0, c = c_lo, t = 0;
    int s = 0, sp = 0, v = 0, vp = 0;
    mbar_wait(&win_full[v], vp);
    load_a(xr, wins + v * WIN, qb[0], qb[1], tq);
    for (;;) {
      mbar_wait(&w_full[s], sp);
      issue<TAU>(acc, xr, hi, lo, ring + s * W_SLOT);
      // the next step, and its window values
      int nt = t + 1, nc = c, nst = st;
      const bool new_chunk = nt == taps;
      if (new_chunk) {
        nt = 0;
        if (++nc == c_hi) {
          nc = c_lo;
          ++nst;
        }
      }
      const bool new_tile = nst != st;
      const bool more = nst < subtiles;
      const int nv = new_chunk ? (v + 1) % WIN_STAGES : v;
      const int nvp = new_chunk && nv == 0 ? vp ^ 1 : vp;
      if (more) {
        if (new_chunk) mbar_wait(&win_full[nv], nvp);
        const int off = (nt / a.kw) * a.win_cols + nt % a.kw;
        load_a(xr, wins + nv * WIN, qb[0] + off, qb[1] + off, tq);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      // each warp hands back what it has finished reading: the weight slot,
      // and the window once its chunk's last tap is done
      if (lane == 0) {
        mbar_arrive(&w_empty[s]);
        if (new_chunk) mbar_arrive(&win_empty[v]);
      }
      if (++s == S) {
        s = 0;
        sp ^= 1;
      }
      if (new_chunk) {
#pragma unroll
        for (int i = 0; i < TAU / 2; ++i) {
          sum[i] += acc[i];
          acc[i] = 0.0f;
        }
      }
      if (new_tile) {
        tile_epilogue<TAU>(sum, a, out, epi, b, ry0, rx0, rh, rw, n0, st, nsx, p0, tq);
#pragma unroll
        for (int i = 0; i < TAU / 2; ++i) sum[i] = 0.0f;
      }
      if (!more) break;
      st = nst;
      c = nc;
      t = nt;
      v = nv;
      vp = nvp;
    }
  }
}

// w (taps, Cin, Cout) -> wp (2, Cout, taps, Cin): K-major, the hi plane then
// the lo plane; a 32 x 32 tile transposed through shared memory per block.
__global__ void __launch_bounds__(256)
    conv_tc_prep(const float* __restrict__ w, float* __restrict__ wp, int taps, int cin,
                 int cout) {
  __shared__ float tile[32][33];
  const int tap = blockIdx.z, ci0 = blockIdx.y * 32, co0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    const int ci = ci0 + r, co = co0 + tx;
    tile[r][tx] = ci < cin && co < cout ? w[(static_cast<size_t>(tap) * cin + ci) * cout + co]
                                        : 0.0f;
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(cout) * taps * cin;
  for (int r = ty; r < 32; r += 8) {
    const int co = co0 + r, ci = ci0 + tx;
    if (co >= cout || ci >= cin) continue;
    uint32_t hi, lo;
    split_tf32(tile[tx][r], hi, lo);
    const size_t at = (static_cast<size_t>(co) * taps + tap) * cin + ci;
    wp[at] = __uint_as_float(hi);
    wp[plane + at] = __uint_as_float(lo);
  }
}

template <int TAU>
int launch_tau(const CUtensorMap& map_x, const CUtensorMap& map_w, const TcArgs& a, int splits,
               float* out, float* part, const FloatEpilogue& epi, cudaStream_t stream) {
  auto kfn = conv_tc_kernel<TAU>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kfn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int smem = smem_bytes<TAU>(a.win_rows, a.win_cols);
  const dim3 grid(a.n * a.tiles_r * a.tiles_c, (a.cout + TAU - 1) / TAU, splits);
  kfn<<<grid, THREADS, smem, stream>>>(map_x, map_w, a, splits > 1 ? part : out, epi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return launch_split_reduce<float>(part, out, a.n * a.ho * a.wo, a.cout, splits, epi, stream);
}

}  // namespace convtc

// The weight-preparation pass: w (K, K, Cin, Cout) f32 -> wp (2, Cout, K·K,
// Cin), the TF32 hi and lo planes.
inline int launch_conv_tc_prep(const void* w, void* wp, int taps, int cin, int cout,
                               cudaStream_t stream) {
  if (taps < 1 || cin < 1 || cout < 1 || taps > 65535) return REPRO_BAD_ARG;
  const dim3 grid((cout + 31) / 32, (cin + 31) / 32, taps);
  if (grid.y > 65535) return REPRO_BAD_ARG;
  convtc::conv_tc_prep<<<grid, 256, 0, stream>>>(static_cast<const float*>(w),
                                                 static_cast<float*>(wp), taps, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core conv on x (NHWC f32) and the prepared weights wp.  geom:
// conv2d.cu's 18-int ConvGeom, with chunk = 32 and (sub_h, sub_w) the
// sub-tile; ``part`` the (splits, N·Ho·Wo, Cout) workspace when splits > 1.
inline int launch_conv_tc(const void* x, const void* wp, void* out, float* part,
                          const int* geom, int splits, const FloatEpilogue& epi,
                          cudaStream_t stream) {
  using namespace convtc;
  TcArgs a{};
  a.n = geom[0], a.h = geom[1], a.w = geom[2], a.cin = geom[3];
  a.kh = geom[4], a.kw = geom[5], a.stride = geom[6], a.pad = geom[7];
  a.ho = geom[8], a.wo = geom[9], a.cout = geom[10];
  const int tau = geom[11], chunk = geom[12];
  a.tile_rows = geom[13], a.tile_cols = geom[14], a.tiles_c = geom[15];
  a.sub_h = geom[16], a.sub_w = geom[17];
  if (chunk != CHUNK || (tau != 64 && tau != 128)) return REPRO_BAD_ARG;
  if (a.n < 1 || a.cin < 8 || a.cin % 8 || a.cout < 8 || a.cout % 8) return REPRO_BAD_ARG;
  if (a.kh < 1 || a.kw < 1 || a.stride < 1 || a.pad < 0) return REPRO_BAD_ARG;
  if (a.ho != (a.h + 2 * a.pad - a.kh) / a.stride + 1 || a.ho < 1) return REPRO_BAD_ARG;
  if (a.wo != (a.w + 2 * a.pad - a.kw) / a.stride + 1 || a.wo < 1) return REPRO_BAD_ARG;
  if (a.sub_h < 1 || a.sub_w < 1 || a.sub_h * a.sub_w > BM) return REPRO_BAD_ARG;
  if (a.tile_rows < 1 || a.tile_cols < 1) return REPRO_BAD_ARG;
  if (a.tiles_c != (a.wo + a.tile_cols - 1) / a.tile_cols) return REPRO_BAD_ARG;
  a.tiles_r = (a.ho + a.tile_rows - 1) / a.tile_rows;
  a.win_rows = (a.sub_h - 1) * a.stride + a.kh;
  a.win_cols = (a.sub_w - 1) * a.stride + a.kw;
  if (a.win_rows > MAX_BOX || a.win_cols > MAX_BOX) return REPRO_BAD_ARG;
  const int smem = tau == 128 ? smem_bytes<128>(a.win_rows, a.win_cols)
                              : smem_bytes<64>(a.win_rows, a.win_cols);
  if (smem > SMEM_LIMIT) return REPRO_BAD_ARG;
  a.chunks = (a.cin + CHUNK - 1) / CHUNK;
  if (splits < 1 || splits > a.chunks) return REPRO_BAD_ARG;
  a.per_split = (a.chunks + splits - 1) / splits;
  if ((splits - 1) * a.per_split >= a.chunks) return REPRO_BAD_ARG;  // an empty split
  if (splits > 1 && part == nullptr) return REPRO_BAD_ARG;
  const long long blocks = static_cast<long long>(a.n) * a.tiles_r * a.tiles_c;
  if (blocks > 0x7fffffffLL || splits > 65535) return REPRO_BAD_ARG;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wp) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(part) % 16)
    return REPRO_BAD_ARG;
  const int taps = a.kh * a.kw;
  CUtensorMap map_x, map_w;
  const cuuint64_t bx = static_cast<cuuint64_t>(a.cin) * 4;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(a.cin), static_cast<cuuint64_t>(a.w),
                               static_cast<cuuint64_t>(a.h), static_cast<cuuint64_t>(a.n)};
  const cuuint64_t xstrides[3] = {bx, bx * a.w, bx * a.w * a.h};
  const cuuint32_t xbox[4] = {CHUNK, static_cast<cuuint32_t>(a.win_cols),
                              static_cast<cuuint32_t>(a.win_rows), 1};
  const cuuint64_t wdims[4] = {static_cast<cuuint64_t>(a.cin), static_cast<cuuint64_t>(taps),
                               static_cast<cuuint64_t>(a.cout), 2};
  const cuuint64_t wstrides[3] = {bx, bx * taps, bx * taps * a.cout};
  const cuuint32_t wbox[4] = {CHUNK, 1, static_cast<cuuint32_t>(tau), 2};
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!make_map_4d(&map_x, f32, x, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_4d(&map_w, f32, wp, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return REPRO_BAD_ARG;
  float* o = static_cast<float*>(out);
  return tau == 128 ? launch_tau<128>(map_x, map_w, a, splits, o, part, epi, stream)
                    : launch_tau<64>(map_x, map_w, a, splits, o, part, epi, stream);
}

}  // namespace repro
#endif  // REPRO_CPU_SHIM
