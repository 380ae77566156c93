// Route wgmma of the q16 GEMM: int16 / int8 raws on the int8 tensor cores,
// for m > 16.
//
// Replaces, with gemm_splitk.cuh (m <= 16), the TPU kernel
// repro/kernels/matmul_q16.py:_qmm_kernel (via matmul_q16_pallas) for the
// GEMMs with many rows: every grid-resident prefill GEMM (m = 4 x 4096)
// and the im2col route of the fixed-point conv.
//
// What bounds it on an H100: the operations.  Hopper's integer wgmma takes
// 8-bit operands (.s8 or .u8, each operand its own) into s32 accumulators
// at 1979 TOPS dense; it has no 16-bit integer type.  But an int16 raw is
// exactly hi·2^8 + lo with hi = x >> 8 a signed byte and lo = x & 0xFF an
// unsigned one, so
//   x·w = hh·2^16 + (hl + lh)·2^8 + ll      (mod 2^32)
// with each limb product summed on its own: an s32 accumulator without
// .satfinite wraps mod 2^32, and the recombination in uint32_t is then
// exact mod 2^32, which is the reference's int32 dot.  int16 x int16 costs
// four s8 / u8 products per k step, int16 x int8 two, int8 x int8 one (the
// bound: 2·m·n·k operations times the limb products at 1979 TOPS).  The
// design:
//   * a preparation launch (prep_kernel, also under the CPU shim) writes
//     each operand as dense byte planes: x (m, k) -> (m, kp) hi and lo
//     planes (one plane for int8, which an aligned x skips: TMA reads it in
//     place); w (k, n) -> (n, kp) planes, transposed through shared memory,
//     because 8-bit wgmma takes only K-major operands (its transpose flag
//     exists for 16-bit types alone); k is padded with zeros to kp, a
//     multiple of the 128-byte k step, so every shape is legal;
//   * the main kernel is gemm_wgmma.cuh's pipeline on the planes: a
//     persistent block per SM owns 128 x BN output tiles; one producer
//     thread keeps a ring of stages full with TMA loads of every plane's
//     128-byte-swizzled 128 x 128 (A) and BN x 128 (B) boxes, a full and an
//     empty mbarrier a stage; two consumer warpgroups of 64 rows each issue
//     wgmma.mma_async m64nBNk32 on the limb pairs, one stage's wgmmas in
//     flight while they wait for the previous stage's;
//   * registers: a m64nBN s32 accumulator is BN / 2 registers a thread and
//     int16 x int16 keeps three (hh, hl + lh, ll), so that mix takes BN 64
//     (96 registers); mixes with at most two limb products may take BN 128
//     (at most 128); BN 64 takes every mix;
//   * shared memory: a stage is (planes of A) x 16 KB + (planes of B) x BN
//     x 128 bytes, 24-48 KB; the ring holds as many as fit 192 KB (4-8);
//   * the epilogue recombines the limb sums in uint32_t, runs common.cuh's
//     IntEpilogue (bias << bias_shift, ReLU, shift_saturate onto the int16
//     or int8 rung, or the raw int32) and stores straight from registers.
// The tensor-core part is inline PTX for sm_90a, so only the preparation
// exists under the CPU shim (REPRO_CPU_SHIM).
#pragma once

#include "common.cuh"

namespace repro {
namespace q16wg {

constexpr int BM = 128;      // output rows of a block: two consumer warpgroups of 64
constexpr int BK = 128;      // k per stage: 128 bytes, one 128-byte swizzle row
constexpr int THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr int GROUP_M = 16;  // m-tiles per group of the tile order

constexpr int PREP_THREADS = 256;
constexpr int XP_ROWS = 8;    // x rows of a preparation block, 32 threads each
constexpr int XP_COLS = 256;  // k columns of a preparation block, 8 a thread
constexpr int WP_TILE = 64;   // w is transposed in 64 (k) x 64 (n) tiles

__device__ __forceinline__ uint2 pack8(const uint8_t (&b)[8]) {
  uint2 o;
  o.x = b[0] | (b[1] << 8) | (b[2] << 16) | (static_cast<uint32_t>(b[3]) << 24);
  o.y = b[4] | (b[5] << 8) | (b[6] << 16) | (static_cast<uint32_t>(b[7]) << 24);
  return o;
}

// The preparation: blocks [0, xblocks) write x's planes (null xp: x is read
// in place), the others w's.  Planes are (limbs, rows, kp) bytes.
template <typename TX, typename TW>
__global__ void __launch_bounds__(PREP_THREADS)
    prep_kernel(const TX* __restrict__ x, const TW* __restrict__ w, uint8_t* __restrict__ xp,
                uint8_t* __restrict__ wp, int m, int n, int k, int kp, int xblocks) {
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < xblocks) {
    // x (m, k) -> (m, kp): thread row tid / 32, 8 consecutive k a thread
    const int col_blocks = (kp + XP_COLS - 1) / XP_COLS;
    const int r = (blockIdx.x / col_blocks) * XP_ROWS + tid / 32;
    const int c = (blockIdx.x % col_blocks) * XP_COLS + (tid % 32) * 8;
    if (r >= m || c >= kp) return;
    const TX* row = x + static_cast<size_t>(r) * k;
    int32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c + j < k ? widen(row[c + j]) : 0;
#pragma unroll
    for (int l = 0; l < Limbs<TX>::N; ++l) {
      uint8_t b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Limbs<TX>::byte(v[j], l);
      *reinterpret_cast<uint2*>(xp + (static_cast<size_t>(l) * m + r) * kp + c) = pack8(b);
    }
    return;
  }
  // w (k, n) -> (n, kp): a 64 x 64 tile through shared memory, read along n
  // and written along k
  __shared__ int32_t tile[WP_TILE][WP_TILE + 1];
  const int b = blockIdx.x - xblocks;
  const int ntiles = (n + WP_TILE - 1) / WP_TILE;
  const int n0 = (b % ntiles) * WP_TILE, k0 = (b / ntiles) * WP_TILE;
  for (int i = tid; i < WP_TILE * WP_TILE; i += PREP_THREADS) {
    const int kk = i / WP_TILE, nn = i % WP_TILE;
    tile[kk][nn] = (k0 + kk < k && n0 + nn < n)
                       ? widen(w[static_cast<size_t>(k0 + kk) * n + n0 + nn])
                       : 0;
  }
  __syncthreads();
  for (int i = tid; i < WP_TILE * (WP_TILE / 8); i += PREP_THREADS) {
    const int nn = i / (WP_TILE / 8), c8 = (i % (WP_TILE / 8)) * 8;
    if (n0 + nn >= n) continue;
#pragma unroll
    for (int l = 0; l < Limbs<TW>::N; ++l) {
      uint8_t bytes[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bytes[j] = Limbs<TW>::byte(tile[c8 + j][nn], l);
      *reinterpret_cast<uint2*>(wp + (static_cast<size_t>(l) * n + n0 + nn) * kp + k0 + c8) =
          pack8(bytes);
    }
  }
}

template <typename TX, typename TW>
int launch_prep_typed(const void* x, const void* w, uint8_t* xp, uint8_t* wp, int m, int n,
                      int k, int kp, cudaStream_t stream) {
  const long xblocks = xp == nullptr ? 0L
                                     : static_cast<long>((m + XP_ROWS - 1) / XP_ROWS) *
                                           ((kp + XP_COLS - 1) / XP_COLS);
  const long wblocks = static_cast<long>((n + WP_TILE - 1) / WP_TILE) * (kp / WP_TILE);
  if (xblocks + wblocks > 0x7fffffffL) return REPRO_BAD_ARG;
  auto kfn = prep_kernel<TX, TW>;
  LAUNCH(kfn, dim3(static_cast<unsigned>(xblocks + wblocks)), dim3(PREP_THREADS), 0, stream,
         static_cast<const TX*>(x), static_cast<const TW*>(w), xp, wp, m, n, k, kp,
         static_cast<int>(xblocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace q16wg

// The preparation launch of route wgmma: x (m, k) and w (k, n) raws of
// xbits / wbits (8 or 16) into the byte planes xp (limbs, m, kp), or null
// when x, int8 with 16-byte rows, is read in place, and wp (limbs, n, kp);
// kp a multiple of the k step BK, at least k and less than k + BK.
inline int launch_q16_prep(const void* x, int xbits, const void* w, int wbits, void* xp,
                           void* wp, int m, int n, int k, int kp, cudaStream_t stream) {
  using namespace q16wg;
  if (m <= 0 || n <= 0 || k <= 0 || kp % BK != 0 || kp < k || kp >= k + BK) return REPRO_BAD_ARG;
  if (wp == nullptr || (xp == nullptr && (xbits != 8 || k % 16 != 0))) return REPRO_BAD_ARG;
  uint8_t* xb = static_cast<uint8_t*>(xp);
  uint8_t* wb = static_cast<uint8_t*>(wp);
  if (xbits == 16 && wbits == 16)
    return launch_prep_typed<int16_t, int16_t>(x, w, xb, wb, m, n, k, kp, stream);
  if (xbits == 16 && wbits == 8)
    return launch_prep_typed<int16_t, int8_t>(x, w, xb, wb, m, n, k, kp, stream);
  if (xbits == 8 && wbits == 16)
    return launch_prep_typed<int8_t, int16_t>(x, w, xb, wb, m, n, k, kp, stream);
  if (xbits == 8 && wbits == 8)
    return launch_prep_typed<int8_t, int8_t>(x, w, xb, wb, m, n, k, kp, stream);
  return REPRO_BAD_ARG;
}

}  // namespace repro

#ifndef REPRO_CPU_SHIM
#include "hopper.cuh"

namespace repro {
namespace q16wg {

using namespace hopper;

// LX / LW: planes of x / w (2 for int16, 1 for int8).  The limb products
// go to s32 accumulators a0..a2, one per product except that int16 x int16
// sums hl and lh in one (three).
template <int LX, int LW, int BN>
struct Cfg {
  static constexpr int A_PLANE = BM * BK;
  static constexpr int B_PLANE = BN * BK;
  static constexpr int STAGE = LX * A_PLANE + LW * B_PLANE;
  static constexpr int STAGES = 196608 / STAGE < 8 ? 196608 / STAGE : 8;
  // the ring, alignment slack, the barriers
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;
};

template <int BN, bool AU, bool BU>
__device__ __forceinline__ void mma(uint32_t (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) {
    mma_i8_m64n64k32<AU, BU>(d, da, db);
  } else {
    mma_i8_m64n128k32<AU, BU>(d, da, db);
  }
}

// Tile t of the grouped order: GROUP_M m-tiles side by side walk the
// n-tiles, so the tiles in flight at one time share x rows and w columns.
__device__ __forceinline__ void tile_origin(int t, int mtiles, int ntiles, int bn, int& m0,
                                            int& n0) {
  const int per_group = GROUP_M * ntiles;
  const int first = (t / per_group) * GROUP_M;
  const int rows_in_group = min(mtiles - first, GROUP_M);
  const int in_group = t % per_group;
  m0 = (first + in_group % rows_in_group) * BM;
  n0 = (in_group / rows_in_group) * bn;
}

// Two neighbouring outputs of one row (columns c and c + 1), one store when
// ``pair`` (n even, so the pair is aligned) and both exist.
template <typename TO>
__device__ __forceinline__ void put2(void* out, size_t idx, int c, int n, bool pair,
                                     const IntEpilogue& epi, uint32_t v0, uint32_t v1) {
  struct alignas(2 * sizeof(TO)) Two {
    TO a, b;
  };
  TO* o = static_cast<TO*>(out) + idx;
  const TO a = epi.template apply<TO>(v0, c);
  if (c + 1 >= n) {
    o[0] = a;
    return;
  }
  const TO b = epi.template apply<TO>(v1, c + 1);
  if (pair) {
    *reinterpret_cast<Two*>(o) = Two{a, b};
  } else {
    o[0] = a;
    o[1] = b;
  }
}

// One consumer's 64 x BN tile of totals onto the output.  Accumulator
// layout of m64nN: register 4j + 2h + e holds row 16·warp + lane/4 + 8h,
// column 8j + 2·(lane%4) + e; r0 and c0 are this thread's first row and
// column.
template <typename TO, int R>
__device__ __forceinline__ void store_tile(void* out, const uint32_t (&acc)[R], int m, int n,
                                           int r0, int c0, const IntEpilogue& epi) {
  const bool pair = n % 2 == 0;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int c = c0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < m && c < n)
        put2<TO>(out, static_cast<size_t>(r) * n + c, c, n, pair, epi, acc[4 * j + 2 * h],
                 acc[4 * j + 2 * h + 1]);
    }
  }
}

// Persistent: each block walks tiles blockIdx.x, + gridDim.x, ...; the
// producer runs ahead across tile boundaries, so the next tile's loads
// overlap this tile's epilogue.  Plane 0 of an operand is its signed byte
// (hi, or the int8 raw), plane 1 the unsigned lo byte.
template <int LX, int LW, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    q16_wgmma_kernel(const __grid_constant__ CUtensorMap map_x0,
                     const __grid_constant__ CUtensorMap map_x1,
                     const __grid_constant__ CUtensorMap map_w0,
                     const __grid_constant__ CUtensorMap map_w1, void* __restrict__ out,
                     int m, int n, int ksteps, IntRungEpilogue epi) {
  using C = Cfg<LX, LW, BN>;
  constexpr int S = C::STAGES;
  constexpr int R = BN / 2;  // accumulator registers a thread, per accumulator
  DYN_SMEM(raw);
  // the 128-byte swizzle repeats every 1024 bytes: stages start on that grid
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S * C::STAGE);
  uint64_t* empty = full + S;

  const int mtiles = (m + BM - 1) / BM, ntiles = (n + BN - 1) / BN;
  const int tiles = mtiles * ntiles;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int s = 0, phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, mtiles, ntiles, BN, m0, n0);
        for (int kt = 0; kt < ksteps; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], C::STAGE);
          unsigned char* sa = base + s * C::STAGE;
          unsigned char* sb = sa + LX * C::A_PLANE;
          tma_load(sa, &map_x0, &full[s], kt * BK, m0);
          if (LX == 2) tma_load(sa + C::A_PLANE, &map_x1, &full[s], kt * BK, m0);
          tma_load(sb, &map_w0, &full[s], kt * BK, n0);
          if (LW == 2) tma_load(sb + C::B_PLANE, &map_w1, &full[s], kt * BK, n0);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups: rows 64 (wg - 1) .. 64 wg - 1 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int half = wg - 1;
    const int t128 = threadIdx.x % 128;
    uint32_t a0[R], a1[LX * LW >= 2 ? R : 1], a2[LX * LW == 4 ? R : 1];
    int s = 0, phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_origin(t, mtiles, ntiles, BN, m0, n0);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a0[i] = 0u;
        if constexpr (LX * LW >= 2) a1[i] = 0u;
        if constexpr (LX * LW == 4) a2[i] = 0u;
      }
      int prev = -1;
      for (int kt = 0; kt < ksteps; ++kt) {
        mbar_wait(&full[s], phase);
        const unsigned char* sa = base + s * C::STAGE + half * 64 * BK;
        const unsigned char* sb = base + s * C::STAGE + LX * C::A_PLANE;
        // K-major, 128-byte swizzle: 8-row groups 1024 bytes apart; a k32
        // step is 32 bytes (2 descriptor units) on
        const uint64_t dx0 = smem_desc(sa, 16, 1024);
        const uint64_t dx1 = smem_desc(sa + (LX - 1) * C::A_PLANE, 16, 1024);
        const uint64_t dw0 = smem_desc(sb, 16, 1024);
        const uint64_t dw1 = smem_desc(sb + (LW - 1) * C::B_PLANE, 16, 1024);
        fence_regs(a0);
        if constexpr (LX * LW >= 2) fence_regs(a1);
        if constexpr (LX * LW == 4) fence_regs(a2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          const int o = 2 * kk;
          if constexpr (LX == 2 && LW == 2) {
            mma<BN, false, false>(a0, dx0 + o, dw0 + o);  // hh
            mma<BN, false, true>(a1, dx0 + o, dw1 + o);   // hl
            mma<BN, true, true>(a2, dx1 + o, dw1 + o);    // ll
            mma<BN, true, false>(a1, dx1 + o, dw0 + o);   // lh
          } else if constexpr (LX == 2) {
            mma<BN, false, false>(a0, dx0 + o, dw0 + o);  // x hi . w
            mma<BN, true, false>(a1, dx1 + o, dw0 + o);   // x lo . w
          } else if constexpr (LW == 2) {
            mma<BN, false, false>(a0, dx0 + o, dw0 + o);  // x . w hi
            mma<BN, false, true>(a1, dx0 + o, dw1 + o);   // x . w lo
          } else {
            mma<BN, false, false>(a0, dx0 + o, dw0 + o);
          }
        }
        wgmma_commit();
        // keep this step's wgmmas in flight; the previous step's are done,
        // so its stage goes back to the producer
        wgmma_wait<1>();
        fence_regs(a0);
        if constexpr (LX * LW >= 2) fence_regs(a1);
        if constexpr (LX * LW == 4) fence_regs(a2);
        if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(a0);
      if constexpr (LX * LW >= 2) fence_regs(a1);
      if constexpr (LX * LW == 4) fence_regs(a2);
      if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);

      // epilogue: the limb sums recombined mod 2^32 in place, then
      // IntEpilogue onto the rung, stored from registers
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if constexpr (LX * LW == 4) {
          a0[i] = (a0[i] << 16) + (a1[i] << 8) + a2[i];
        } else if constexpr (LX * LW == 2) {
          a0[i] = (a0[i] << 8) + a1[i];
        }
      }
      const int r0 = m0 + half * 64 + (t128 / 32) * 16 + (t128 % 32) / 4;
      const int c0 = n0 + 2 * (t128 % 4);
      if (epi.obits == 16)
        store_tile<int16_t>(out, a0, m, n, r0, c0, epi.epi);
      else if (epi.obits == 8)
        store_tile<int8_t>(out, a0, m, n, r0, c0, epi.epi);
      else
        store_tile<int32_t>(out, a0, m, n, r0, c0, epi.epi);
    }
  }
}

template <int LX, int LW, int BN>
int launch_cfg(const CUtensorMap (&mx)[2], const CUtensorMap (&mw)[2], void* out, int m,
               int n, int ksteps, int sms, const IntRungEpilogue& epi, cudaStream_t stream) {
  auto kfn = q16_wgmma_kernel<LX, LW, BN>;
  constexpr int smem = Cfg<LX, LW, BN>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kfn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long tiles = static_cast<long>((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (tiles > 0x7fffffffL) return REPRO_BAD_ARG;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kfn<<<grid, THREADS, smem, stream>>>(mx[0], mx[1], mw[0], mw[1], out, m, n, ksteps, epi);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bn(int lx, int lw, const CUtensorMap (&mx)[2], const CUtensorMap (&mw)[2],
              void* out, int m, int n, int ksteps, int sms, const IntRungEpilogue& epi,
              cudaStream_t stream) {
  if (lx == 2 && lw == 2) {
    if constexpr (BN == 64)
      return launch_cfg<2, 2, BN>(mx, mw, out, m, n, ksteps, sms, epi, stream);
    return REPRO_BAD_ARG;  // three accumulators of BN / 2 registers: BN 64 only
  }
  if (lx == 2) return launch_cfg<2, 1, BN>(mx, mw, out, m, n, ksteps, sms, epi, stream);
  if (lw == 2) return launch_cfg<1, 2, BN>(mx, mw, out, m, n, ksteps, sms, epi, stream);
  return launch_cfg<1, 1, BN>(mx, mw, out, m, n, ksteps, sms, epi, stream);
}

}  // namespace q16wg

// Route wgmma on the planes of launch_q16_prep: xsrc the x planes (limbs,
// m, kp), or x itself (int8, k a multiple of 16) when x_in_place; wp the w
// planes (limbs, n, kp); out (m, n) on the epilogue's rung (8, 16, or 32
// bits: the raw accumulator); tile (bm, bn, bk) (128, 64, 128), or (128,
// 128, 128) for at most two limb products.
inline int launch_q16_wgmma(const void* xsrc, int xbits, int x_in_place, const void* wp,
                            int wbits, void* out, int m, int n, int k, int kp, int bm, int bn,
                            int bk, const IntRungEpilogue& epi, cudaStream_t stream) {
  using namespace q16wg;
  if (bm != BM || bk != BK || (bn != 64 && bn != 128)) return REPRO_BAD_ARG;
  if ((xbits != 8 && xbits != 16) || (wbits != 8 && wbits != 16)) return REPRO_BAD_ARG;
  if (epi.obits != 8 && epi.obits != 16 && epi.obits != 32) return REPRO_BAD_ARG;
  if (m <= 0 || n <= 0 || k <= 0 || kp % BK != 0 || kp < k || kp >= k + BK) return REPRO_BAD_ARG;
  if (x_in_place && (xbits != 8 || k % 16 != 0)) return REPRO_BAD_ARG;
  if (reinterpret_cast<uintptr_t>(xsrc) % 16 || reinterpret_cast<uintptr_t>(wp) % 16)
    return REPRO_BAD_ARG;
  const int lx = xbits / 8, lw = wbits / 8;
  const unsigned char* xb = static_cast<const unsigned char*>(xsrc);
  const unsigned char* wb = static_cast<const unsigned char*>(wp);
  CUtensorMap mx[2], mw[2];
  for (int p = 0; p < 2; ++p) {
    const int px = p < lx ? p : 0, pw = p < lw ? p : 0;  // an unused map repeats plane 0
    const bool ok =
        (x_in_place ? make_map_bytes(&mx[p], xb, m, k, k, BM)
                    : make_map_bytes(&mx[p], xb + static_cast<size_t>(px) * m * kp, m, kp, kp,
                                     BM)) &&
        make_map_bytes(&mw[p], wb + static_cast<size_t>(pw) * n * kp, n, kp, kp, bn);
    if (!ok) return REPRO_BAD_ARG;
  }
  static int sms_of[64] = {};  // SMs of each device, asked once
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return REPRO_BAD_ARG;
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int ksteps = kp / BK;
  if (bn == 64)
    return launch_bn<64>(lx, lw, mx, mw, out, m, n, ksteps, sms_of[device], epi, stream);
  return launch_bn<128>(lx, lw, mx, mw, out, m, n, ksteps, sms_of[device], epi, stream);
}

}  // namespace repro
#endif  // REPRO_CPU_SHIM
