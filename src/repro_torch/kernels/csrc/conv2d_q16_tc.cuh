// Tensor-core route of the fixed-point direct conv: an implicit GEMM on s8 /
// u8 limb wgmmas into s32 accumulators, for sm_90a.
//
// Replaces, with conv2d.cu's CUDA-core conv_kernel, the TPU kernel
// repro/kernels/conv2d.py:conv2d_q16_pallas (kernel _conv_q16_kernel) and,
// through the same code, its manual-DMA regime _conv_dma_call
// (_conv_dma_kernel) on int16 / int8 raws, for every fixed-point conv whose
// Cin·bytes is a multiple of 16 and whose Cout is a multiple of 8 (VGG16
// conv1-12, AlexNet conv1-4); the planner (core/dse.py) sends the others
// (the zoo's first layers, LeNet's Cout 6) to conv_kernel.
//
// What bounds it on an H100: the operations.  Hopper's integer wgmma takes
// 8-bit operands into s32 accumulators (1979 TOPS dense) and has no 16-bit
// integer type.  An int16 raw is exactly hi·2^8 + lo with hi = x >> 8 a
// signed byte and lo = x & 0xFF an unsigned one, so
//   x·w = hh·2^16 + (hl + lh)·2^8 + ll      (mod 2^32)
// with each limb product summed on its own in an s32 accumulator without
// .satfinite (it wraps mod 2^32) and the recombination done in uint32_t:
// exactly the reference's int32 sum.  int16 x int16 costs four limb
// products, a mix with one int8 operand two, int8 x int8 one (the bound:
// 2·N·Ho·Wo·Cout·K²·Cin operations times the limb products at 1979 TOPS).
//
// The design (conv2d_tc.cuh's shape with gemm_q16_wgmma.cuh's arithmetic):
//   * GEMM view: M = output pixels of a sub-tile (BM = 128: two consumer
//     warpgroups of 64 rows), N = a slice of τ output channels, K = taps x
//     Cin, walked as (Cin chunk of 64, group of three taps) steps: one
//     weight slot and one wgmma group (up to 24 of them) a step, so a
//     step's barrier waits, index work and drain are spread over three taps'
//     wgmmas.  The output regions (the
//     plan's tile, or one sub-tile) are cut into sub-tiles of sub_h x sub_w
//     <= 128 pixels; a work item is one sub-tile, τ slice and Cin split;
//   * persistence: one block per SM walks the items (blockIdx.x, + the
//     grid, ...), in an order that has the blocks running at one time share
//     a τ slice, so the producer loads the next item's window and weights
//     while this one computes and writes back.  (One block per sub-tile left
//     every block's start and first window fetch exposed: VGG16 conv1 is
//     3,136 sub-tiles of 9 steps each);
//   * staging: one producer thread keeps two rings full with TMA.  The
//     input window of a sub-tile and chunk -- (sub_h-1)·stride+kh rows by
//     (sub_w-1)·stride+kw columns of 64 channels, the raws as they lie in
//     NHWC: a pixel is one 128-byte swizzle row of int16 or one 64-byte row
//     of int8 -- is one box of a 4-D tensor map over x; TMA fills
//     coordinates past the image and past Cin with zeros, which is the pad.
//     A step's weight slabs are one box a tap of a 4-D map over the
//     prepared byte planes (every limb at once, 64-byte swizzle rows); each
//     ring slot has a full mbarrier and an empty one, so loads run ahead of
//     math;
//   * A operand, the pixels: a tap is a shifted view of the window, whose
//     rows are not at a fixed stride, so no descriptor can address it.  Each
//     consumer thread reads its fragment for the tap from the staged raws,
//     splits int16 into its hi and lo bytes in registers (two byte
//     permutes), and issues register-A wgmma.  No byte planes of x go to
//     device memory and no x preparation launch runs;
//   * B operand, the weights: the port keeps them (K, K, Cin, Cout), N-major,
//     and 8-bit wgmma takes only K-major operands, so a preparation launch
//     per call (q16_conv_prep, plain CUDA, also under the CPU shim) writes
//     them as (limbs, Cout, K·K, Cinp) bytes, Cin zero-padded to the chunk;
//   * accumulation: integer adds are exact, so every chunk and tap of a
//     sub-tile accumulates in the same s32 registers, with no per-chunk sum
//     on the CUDA cores.  int16 x int16 keeps three accumulators (hh, hl +
//     lh, ll), 96 registers a thread at τ 64, so every mix takes τ 64 (at
//     τ 128 int16 x int16 would need 192; a mix with an int8 operand would
//     fit, but only int8 x int8 gained on the card, and no plan sees the
//     raws' widths);
//   * pipelining: for int16 x (where the accumulators leave room), while
//     one step's wgmmas run, the next step's raws load into plain
//     registers; they are split into the A registers only after the running
//     group has been waited for (a register-A wgmma reads its registers
//     until then), and the other warpgroup's wgmmas fill the gap.  An int8
//     x needs no split, so its raws are the A registers themselves: loaded
//     during the flight they were the running wgmma's operands (the card
//     gave wrong, unrepeatable sums), so they load after the wait;
//   * a Cin split: when the grid has too few blocks for the 132 SMs, blocks
//     also split the Cin chunks; each writes its uint32_t partial sums to a
//     (splits, N·Ho·Wo, Cout) workspace and common.cuh's
//     split_reduce_kernel adds them in split order and runs the epilogue.
//     No atomics: the same bits on every run;
//   * epilogue: the limb sums recombined in uint32_t, then common.cuh's
//     IntRungEpilogue (bias << bias_shift, ReLU, shift-saturate onto the
//     int16 or int8 rung), staged in shared memory and written to NHWC as
//     vectors of 8 channels.
// TMA needs 16-byte row strides and bases: Cin·bytes a multiple of 16,
// Cout a multiple of 8, 16-byte aligned operands; the launcher refuses
// anything else, and never moves a call to conv_kernel.
//
// The tensor-core part is inline PTX for sm_90a, so only the weight
// preparation exists under the CPU shim (REPRO_CPU_SHIM).
#pragma once

#include "common.cuh"

namespace repro {
namespace convq {

constexpr int CHUNK = 64;  // Cin per step: one swizzle row of int16 (128 bytes) or int8 (64)

// w (taps, Cin, Cout) raws -> wp (limbs, Cout, taps, cinp) bytes, zeros from
// Cin to cinp: a 32 (Cin) x 32 (Cout) tile a block, transposed through
// shared memory.
template <typename TW>
__global__ void __launch_bounds__(256)
    q16_conv_prep(const TW* __restrict__ w, uint8_t* __restrict__ wp, int taps, int cin,
                  int cinp, int cout) {
  __shared__ int32_t tile[32][33];
  const int tap = blockIdx.z, ci0 = blockIdx.y * 32, co0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    const int ci = ci0 + r, co = co0 + tx;
    tile[r][tx] = ci < cin && co < cout
                      ? widen(w[(static_cast<size_t>(tap) * cin + ci) * cout + co])
                      : 0;
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(cout) * taps * cinp;
  for (int r = ty; r < 32; r += 8) {
    const int co = co0 + r, ci = ci0 + tx;
    if (co >= cout) continue;
    const size_t at = (static_cast<size_t>(co) * taps + tap) * cinp + ci;
#pragma unroll
    for (int l = 0; l < Limbs<TW>::N; ++l) wp[l * plane + at] = Limbs<TW>::byte(tile[tx][r], l);
  }
}

template <typename TW>
int launch_prep_typed(const void* w, uint8_t* wp, int taps, int cin, int cinp, int cout,
                      cudaStream_t stream) {
  const dim3 grid((cout + 31) / 32, cinp / 32, taps);
  auto kfn = q16_conv_prep<TW>;
  LAUNCH(kfn, grid, dim3(256), 0, stream, static_cast<const TW*>(w), wp, taps, cin, cinp, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace convq

// The weight preparation of the fixed-point tensor-core route: w (K, K, Cin,
// Cout) raws of wbits (8 or 16) -> wp (limbs, Cout, K·K, cinp) bytes, cinp a
// multiple of the 64-channel chunk, at least Cin and less than Cin + 64.
inline int launch_conv_q16_tc_prep(const void* w, int wbits, void* wp, int taps, int cin,
                                   int cout, cudaStream_t stream) {
  using namespace convq;
  if (taps < 1 || taps > 65535 || cin < 1 || cout < 1) return REPRO_BAD_ARG;
  const int cinp = (cin + CHUNK - 1) / CHUNK * CHUNK;
  if (cinp / 32 > 65535) return REPRO_BAD_ARG;
  uint8_t* out = static_cast<uint8_t*>(wp);
  if (wbits == 16) return launch_prep_typed<int16_t>(w, out, taps, cin, cinp, cout, stream);
  if (wbits == 8) return launch_prep_typed<int8_t>(w, out, taps, cin, cinp, cout, stream);
  return REPRO_BAD_ARG;
}

}  // namespace repro

#ifndef REPRO_CPU_SHIM
#include "hopper.cuh"

namespace repro {
namespace convq {

using namespace hopper;

constexpr int BM = 128;        // pixels of a sub-tile: two consumer warpgroups of 64
constexpr int TAU = 64;        // output channels a work item: a τ slice of Cout
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int TPS = 3;         // taps a step: one weight slot, one wgmma group
constexpr int WIN_STAGES = 2;  // input windows in flight
constexpr int MAX_BOX = 256;   // TMA's largest box extent
constexpr int SMEM_LIMIT = 232448;
constexpr int W_RING = 98304;  // the weight ring's bytes: up to 8 slots

// LX / LW: limbs of x / w (2 for int16, 1 for int8).  The limb products go
// to s32 accumulators, one per product except that int16 x int16 sums hl
// and lh in one (three).
template <int LX, int LW>
struct Cfg {
  static constexpr int XROW = CHUNK * LX;      // bytes of one window pixel
  static constexpr int W_PLANE = TAU * CHUNK;  // one limb of one tap's slab
  static constexpr int W_TAP = LW * W_PLANE;
  static constexpr int W_SLOT = TPS * W_TAP;
  static constexpr int W_STAGES = W_RING / W_SLOT < 8 ? W_RING / W_SLOT : 8;
  static constexpr int R = TAU / 2;  // accumulator registers a thread, per accumulator
  static constexpr int NACC = LX * LW == 4 ? 3 : LX * LW;
  // int16 x whose accumulators leave room: the next step's raws load while
  // this step's wgmmas run (48 registers); else they load after the wait
  static constexpr bool PREFETCH = LX == 2 && NACC * R <= 96;
  // a consumer warpgroup's write-back staging: 64 rows of τ int16 outputs,
  // padded by 16 bytes so the rows' pairs fall in different banks
  static constexpr int STAGE_ROW = 2 * TAU + 16;
  static constexpr int STAGE = 64 * STAGE_ROW;
  __host__ __device__ static int win_slot(int rows, int cols) {
    return (rows * cols * XROW + 1023) & ~1023;  // swizzle atoms are at most 1024 bytes
  }
  __host__ __device__ static int smem_bytes(int rows, int cols) {
    // alignment slack, the weight ring, the windows, the staging, the barriers
    return 1024 + W_STAGES * W_SLOT + WIN_STAGES * win_slot(rows, cols) + 2 * STAGE +
           (2 * WIN_STAGES + 2 * W_STAGES) * 8;
  }
};

// Waits until the 128 threads of one consumer warpgroup have arrived at
// named barrier ``id`` (1 or 2; 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

template <bool AU, bool BU>
__device__ __forceinline__ void mma(uint32_t (&d)[TAU / 2], const uint32_t* a, uint64_t db,
                                    int acc = 1) {
  mma_i8_rs_m64n64k32<AU, BU>(d, a, db, acc);
}

// The raws of one tap's A fragments, read from the window: for each k32
// step kk (channels 32kk ..) and half hf (+16), rows q0 (g) and q1 (g + 8),
// the 4 channels 4t .. 4t + 3.  int16: 8 bytes (two words) each, in a
// 128-byte row whose 16-byte chunk c sits at c ^ (q % 8) (TMA's 128-byte
// swizzle); int8: 4 bytes, in a 64-byte row whose chunk c sits at
// c ^ ((q / 2) % 4) (the 64-byte swizzle).  Order: word index
// LX·(4kk + 2hf + h) + word, h the row.
template <int LX>
__device__ __forceinline__ void load_raw(uint32_t* xr, const unsigned char* win, int q0, int q1,
                                         int t) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = h ? q1 : q0;
        const int i = 4 * kk + 2 * hf + h;
        if constexpr (LX == 2) {
          const int c = 4 * kk + 2 * hf + (t >> 1);
          const uint2 v = *reinterpret_cast<const uint2*>(win + q * 128 + ((c ^ (q & 7)) << 4) +
                                                          8 * (t & 1));
          xr[2 * i] = v.x;
          xr[2 * i + 1] = v.y;
        } else {
          const int c = 2 * kk + hf;
          xr[i] = *reinterpret_cast<const uint32_t*>(win + q * 64 +
                                                     ((c ^ ((q >> 1) & 3)) << 4) + 4 * t);
        }
      }
    }
  }
}

// One tap's int16 raws into A registers, in the fragment order of
// mma_i8_rs_*: register 4kk + 2hf + h holds the hi bytes (signed) of four
// raws (two words), al the lo bytes (unsigned).  An int8 x's raws
// (load_raw<1>) are already in that order.
__device__ __forceinline__ void split_raw(const uint32_t* xr, uint32_t* ah, uint32_t* al) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ah[i] = __byte_perm(xr[2 * i], xr[2 * i + 1], 0x7531);
    al[i] = __byte_perm(xr[2 * i], xr[2 * i + 1], 0x6420);
  }
}

// Window offset of tap t (row t / kw, column t % kw of the kernel).
__device__ __forceinline__ int tap_offset(int t, int kw, int win_cols) {
  return (t / kw) * win_cols + t % kw;
}

// One step of a consumer warpgroup: for each of its TPS taps two k32 steps
// of every limb product, committed as one group.  A group is issued whole,
// with no branch between its wgmmas (ptxas fences and drains around one):
// a tap past the kernel's last has zero A registers and adds nothing,
// whatever its slot holds.  An item's first step (``fresh``) starts each
// accumulator with its first wgmma (scale-d 0), so no other instruction
// writes the accumulators.  A tap's
// slab in the slot is its limb planes, plane 0 w's signed byte (hi, or the
// int8 raw), plane 1 the unsigned lo byte, each TAU rows of 64 bytes,
// K-major, 64-byte swizzle, 8-row groups 512 bytes apart; a k32 step is 32
// bytes on (2 descriptor units).
template <int LX, int LW, int R1, int R2>
__device__ __forceinline__ void issue(uint32_t (&a0)[TAU / 2], uint32_t (&a1)[R1],
                                      uint32_t (&a2)[R2], uint32_t (&ah)[8 * TPS],
                                      uint32_t (&al)[8 * TPS], const unsigned char* slot,
                                      bool fresh) {
  using C = Cfg<LX, LW>;
  fence_regs(a0);
  if constexpr (LX * LW >= 2) fence_regs(a1);
  if constexpr (LX * LW == 4) fence_regs(a2);
  fence_regs(ah);
  if constexpr (LX == 2) fence_regs(al);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < TPS; ++j) {
    const unsigned char* slab = slot + j * C::W_TAP;
    const uint64_t d0 = smem_desc(slab, 16, 512, DESC_SW64);
    const uint64_t d1 = smem_desc(slab + (LW - 1) * C::W_PLANE, 16, 512, DESC_SW64);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int o = 2 * kk;
      const uint32_t* h = ah + 8 * j + 4 * kk;
      const uint32_t* l = al + 8 * j + 4 * kk;
      const int acc = !(fresh && j == 0 && kk == 0);
      if constexpr (LX == 2 && LW == 2) {
        mma<false, false>(a0, h, d0 + o, acc);  // hh
        mma<false, true>(a1, h, d1 + o, acc);   // hl
        mma<true, true>(a2, l, d1 + o, acc);    // ll
        mma<true, false>(a1, l, d0 + o);        // lh
      } else if constexpr (LX == 2) {
        mma<false, false>(a0, h, d0 + o, acc);  // x hi . w
        mma<true, false>(a1, l, d0 + o, acc);   // x lo . w
      } else if constexpr (LW == 2) {
        mma<false, false>(a0, h, d0 + o, acc);  // x . w hi
        mma<false, true>(a1, h, d1 + o, acc);   // x . w lo
      } else {
        mma<false, false>(a0, h, d0 + o, acc);
      }
    }
  }
  wgmma_commit();
}

struct QArgs {
  int n, h, w, cin, kh, kw, stride, pad, ho, wo, cout;
  int tile_rows, tile_cols, tiles_r, tiles_c;  // the output regions
  int sub_h, sub_w;                            // a sub-tile: sub_h·sub_w <= BM pixels
  int win_rows, win_cols;                      // its input window
  int chunks, per_split, splits;               // Cin chunks; chunks of one split; splits
  int sub_y, sub_x;                            // sub-tiles a region holds, down and across
  int ntau, items;                             // τ slices of Cout; work items
};

// One work item: a sub-tile of one region of one image, one τ slice of
// Cout and one split of the Cin chunks.
struct Item {
  int b, n0, z, c_lo, c_hi;  // image, first channel, split, its chunks
  int oy0, ox0;              // the sub-tile's first output pixel
  int oy_end, ox_end;        // its region's end
};

// Item ``it`` in the order (split, τ slice, image, region, sub-tile): blocks
// that run at one time share a τ slice and split, so their weight slabs
// are read from L2 together.  False for a sub-tile past its region's edge.
__device__ __forceinline__ bool item_of(const QArgs& a, int it, Item& m) {
  const int spr = a.sub_y * a.sub_x;
  const int per_img = a.tiles_r * a.tiles_c * spr;
  const int per_tau = a.n * per_img;
  m.z = it / (a.ntau * per_tau);
  int r = it % (a.ntau * per_tau);
  m.n0 = (r / per_tau) * TAU;
  r %= per_tau;
  m.b = r / per_img;
  r %= per_img;
  const int rg = r / spr, sp = r % spr;
  const int ry0 = (rg / a.tiles_c) * a.tile_rows, rx0 = (rg % a.tiles_c) * a.tile_cols;
  m.oy_end = min(ry0 + a.tile_rows, a.ho);
  m.ox_end = min(rx0 + a.tile_cols, a.wo);
  m.oy0 = ry0 + (sp / a.sub_x) * a.sub_h;
  m.ox0 = rx0 + (sp % a.sub_x) * a.sub_w;
  m.c_lo = m.z * a.per_split;
  m.c_hi = min(a.chunks, m.c_lo + a.per_split);
  return m.oy0 < m.oy_end && m.ox0 < m.ox_end;
}

// The first item at or after ``it`` (stepping by the grid) that holds
// pixels, or a.items when none is left.
__device__ __forceinline__ int next_item(const QArgs& a, int it, Item& m) {
  for (; it < a.items; it += gridDim.x)
    if (item_of(a, it, m)) return it;
  return a.items;
}

// Output pixel of sub-tile row p (0 .. BM - 1) of an item, or -1 past the
// sub-tile or its region.
__device__ __forceinline__ long long pixel_of(const QArgs& a, const Item& m, int p) {
  const int oy = m.oy0 + p / a.sub_w, ox = m.ox0 + p % a.sub_w;
  if (p >= a.sub_h * a.sub_w || oy >= m.oy_end || ox >= m.ox_end) return -1;
  return (static_cast<long long>(m.b) * a.ho + oy) * a.wo + ox;
}

// One split: this thread's values of an item on the epilogue's rung,
// staged in its two rows of the warpgroup's 64.  EDGE: the item's τ slice
// runs past Cout (the last slice of a Cout that is no multiple of τ); its
// columns past Cout read no bias and are not staged (flush_rows skips
// them).  Every other slice stages with no per-column test.
template <bool EDGE>
__device__ __forceinline__ void stage_rows(const uint32_t (&acc)[TAU / 2], const QArgs& a,
                                           const Item& m, const IntRungEpilogue& epi,
                                           unsigned char* stage, int r0, int t) {
  constexpr int SR = 2 * TAU + 16;  // Cfg::STAGE_ROW
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned char* row = stage + (r0 + 8 * h) * SR;
#pragma unroll
    for (int j = 0; j < TAU / 8; ++j) {
      const int cl = 8 * j + 2 * t, col = m.n0 + cl;
      if (EDGE && col >= a.cout) continue;  // Cout % 8 == 0: col + 1 is past it too
      const uint32_t v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (epi.obits == 16) {
        const uint32_t lo = static_cast<uint16_t>(epi.epi.apply<int16_t>(v0, col));
        const uint32_t hi = static_cast<uint16_t>(epi.epi.apply<int16_t>(v1, col + 1));
        *reinterpret_cast<uint32_t*>(row + 2 * cl) = lo | (hi << 16);
      } else {
        const uint32_t lo = static_cast<uint8_t>(epi.epi.apply<int8_t>(v0, col));
        const uint32_t hi = static_cast<uint8_t>(epi.epi.apply<int8_t>(v1, col + 1));
        *reinterpret_cast<uint16_t*>(row + cl) = static_cast<uint16_t>(lo | (hi << 8));
      }
    }
  }
}

// An item's write-back of the recombined sums.  Accumulator layout of
// m64nN: register 4j + 2h + e holds row 16·warp + g + 8h, column 8j + 2·t +
// e.  Several splits: the item's split plane of the (splits, N·Ho·Wo, Cout)
// workspace, raw, as pairs; returns false.  One split: the epilogue's
// values staged as this warpgroup's 64 rows in shared memory, for
// flush_rows to write out; returns true.
__device__ __forceinline__ bool tile_epilogue(const uint32_t (&acc)[TAU / 2], const QArgs& a,
                                              const Item& m, uint32_t* part,
                                              const IntRungEpilogue& epi, unsigned char* stage,
                                              int half, int p0, int t) {
  if (a.splits > 1) {
    uint32_t* dst = part + static_cast<size_t>(m.z) * a.n * a.ho * a.wo * a.cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long pix = pixel_of(a, m, p0 + 8 * h);
      if (pix < 0) continue;
#pragma unroll
      for (int j = 0; j < TAU / 8; ++j) {
        const int col = m.n0 + 8 * j + 2 * t;
        if (col >= a.cout) continue;  // Cout % 8 == 0: col + 1 exists too
        *reinterpret_cast<uint2*>(dst + pix * a.cout + col) =
            make_uint2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return false;
  }
  const int r0 = p0 - 64 * half;  // this thread's first row of the warpgroup's 64
  wg_sync(1 + half);              // the previous item's rows have been written out
  if (m.n0 + TAU <= a.cout)
    stage_rows<false>(acc, a, m, epi, stage, r0, t);
  else
    stage_rows<true>(acc, a, m, epi, stage, r0, t);
  wg_sync(1 + half);
  return true;
}

// The staged rows of an item written to NHWC as vectors of 8 channels (16
// bytes of int16, 8 of int8): whole 128-byte lines of a pixel where τ int16
// fill them; Cout % 8 == 0, so a vector is whole or past Cout.  (Pairs
// written straight from the registers took longer on the card, and so did
// writing the rows out while the next item's first wgmmas ran.)
__device__ __forceinline__ void flush_rows(const QArgs& a, const Item& m, void* out, int obits,
                                           const unsigned char* stage, int half) {
  constexpr int SR = 2 * TAU + 16;
  constexpr int VECS = TAU / 8;
  const int ob = obits / 8;
  const int t128 = threadIdx.x % 128;
#pragma unroll
  for (int i = t128; i < 64 * VECS; i += 128) {
    const int r = i / VECS, k = i % VECS;
    const long long pix = pixel_of(a, m, 64 * half + r);
    const int col = m.n0 + 8 * k;
    if (pix < 0 || col >= a.cout) continue;
    const unsigned char* src = stage + r * SR + 8 * k * ob;
    unsigned char* dst = static_cast<unsigned char*>(out) + (pix * a.cout + col) * ob;
    if (ob == 2) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    }
  }
}

// Persistent: each block walks the items blockIdx.x, + gridDim.x, ...; the
// producer runs ahead across items, so the next item's window and weights
// load while this one computes and writes back.  splits == 1: ``out`` is
// the NHWC output on the epilogue's rung; else ``part`` the (splits,
// N·Ho·Wo, Cout) workspace, written raw.
template <int LX, int LW>
__global__ void __launch_bounds__(THREADS, 1)
    conv_q16_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w, QArgs a,
                       void* __restrict__ out, uint32_t* __restrict__ part,
                       IntRungEpilogue epi) {
  using C = Cfg<LX, LW>;
  constexpr int S = C::W_STAGES;
  constexpr int R = C::R;
  const int WIN = C::win_slot(a.win_rows, a.win_cols);
  DYN_SMEM(raw);
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = base;
  unsigned char* wins = base + S * C::W_SLOT;
  unsigned char* stages = wins + WIN_STAGES * WIN;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(stages + 2 * C::STAGE);
  uint64_t* w_empty = w_full + S;
  uint64_t* win_full = w_empty + S;
  uint64_t* win_empty = win_full + WIN_STAGES;

  const int taps = a.kh * a.kw;
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
      const uint32_t win_bytes = a.win_rows * a.win_cols * C::XROW;
      int s = 0, sp = 0, v = 0, vp = 0;
      Item m;
      for (int it = next_item(a, blockIdx.x, m); it < a.items;
           it = next_item(a, it + gridDim.x, m)) {
        const int iy = m.oy0 * a.stride - a.pad, ix = m.ox0 * a.stride - a.pad;
        for (int c = m.c_lo; c < m.c_hi; ++c) {
          mbar_wait(&win_empty[v], vp ^ 1);
          mbar_expect_tx(&win_full[v], win_bytes);
          tma_load_4d(wins + v * WIN, &map_x, &win_full[v], c * CHUNK, ix, iy, m.b);
          if (++v == WIN_STAGES) {
            v = 0;
            vp ^= 1;
          }
          for (int t0 = 0; t0 < taps; t0 += TPS) {
            const int n = min(TPS, taps - t0);
            mbar_wait(&w_empty[s], sp ^ 1);
            mbar_expect_tx(&w_full[s], n * C::W_TAP);
            for (int j = 0; j < n; ++j)
              tma_load_4d(ring + s * C::W_SLOT + j * C::W_TAP, &map_w, &w_full[s], c * CHUNK,
                          t0 + j, m.n0, 0);
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
    Item m;
    int it = next_item(a, blockIdx.x, m);
    if (it < a.items) {
      // The steps (item, chunk, tap group of TPS taps) in order.  With
      // PREFETCH, while a step's wgmmas run, the next step's raws load into
      // xr; they become wgmma operands (ah, al) only after the running group
      // has been waited for.  Else each step's raws load after that wait,
      // an int8 x's straight into ah.  a0 .. a2: the item's limb sums over
      // every chunk and tap (a1, a2 unused, one register, where the mix has
      // fewer products), started by the item's first step.
      uint32_t a0[R], a1[LX * LW >= 2 ? R : 1], a2[LX * LW == 4 ? R : 1];
      uint32_t xr[C::PREFETCH ? 16 * TPS : 16];
      uint32_t ah[8 * TPS], al[8 * TPS];
#pragma unroll
      for (int i = 0; i < 8 * TPS; ++i) ah[i] = al[i] = 0u;
      bool fresh = true;
      int c = m.c_lo, t0 = 0;
      int s = 0, sp = 0, v = 0, vp = 0;
      mbar_wait(&win_full[v], vp);
      if constexpr (C::PREFETCH) {
#pragma unroll
        for (int j = 0; j < TPS; ++j)
          if (j < taps)
            load_raw<2>(xr + 16 * j, wins, qb[0] + tap_offset(j, a.kw, a.win_cols),
                        qb[1] + tap_offset(j, a.kw, a.win_cols), tq);
      }
      for (;;) {
        const int n = min(TPS, taps - t0);
#pragma unroll
        for (int j = 0; j < TPS; ++j) {
          if (j >= n) {  // past the last tap: zero operands
#pragma unroll
            for (int i = 0; i < 8; ++i) ah[8 * j + i] = al[8 * j + i] = 0u;
            continue;
          }
          if constexpr (C::PREFETCH) {
            split_raw(xr + 16 * j, ah + 8 * j, al + 8 * j);
          } else {
            const int off = tap_offset(t0 + j, a.kw, a.win_cols);
            if constexpr (LX == 2) {
              load_raw<2>(xr, wins + v * WIN, qb[0] + off, qb[1] + off, tq);
              split_raw(xr, ah + 8 * j, al + 8 * j);
            } else {
              load_raw<1>(ah + 8 * j, wins + v * WIN, qb[0] + off, qb[1] + off, tq);
            }
          }
        }
        mbar_wait(&w_full[s], sp);
        issue<LX, LW>(a0, a1, a2, ah, al, ring + s * C::W_SLOT, fresh);
        fresh = false;
        // the next step, and its raws
        int nt0 = t0 + TPS, nc = c, nit = it;
        Item nm = m;
        const bool new_chunk = nt0 >= taps;
        if (new_chunk) {
          nt0 = 0;
          if (++nc == m.c_hi) {
            nit = next_item(a, it + gridDim.x, nm);
            nc = nm.c_lo;
          }
        }
        const bool new_tile = nit != it;
        const bool more = nit < a.items;
        const int nv = new_chunk ? (v + 1) % WIN_STAGES : v;
        const int nvp = new_chunk && nv == 0 ? vp ^ 1 : vp;
        if (more) {
          if (new_chunk) mbar_wait(&win_full[nv], nvp);
          if constexpr (C::PREFETCH) {
            const int nn = min(TPS, taps - nt0);
#pragma unroll
            for (int j = 0; j < TPS; ++j) {
              if (j >= nn) break;
              const int off = tap_offset(nt0 + j, a.kw, a.win_cols);
              load_raw<2>(xr + 16 * j, wins + nv * WIN, qb[0] + off, qb[1] + off, tq);
            }
          }
        }
        wgmma_wait<0>();
        fence_regs(a0);
        if constexpr (LX * LW >= 2) fence_regs(a1);
        if constexpr (LX * LW == 4) fence_regs(a2);
        fence_regs(ah);
        if constexpr (LX == 2) fence_regs(al);
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
        if (new_tile) {
          // the limb sums recombined mod 2^32 in place, then written back
#pragma unroll
          for (int i = 0; i < R; ++i) {
            if constexpr (LX * LW == 4) {
              a0[i] = (a0[i] << 16) + (a1[i] << 8) + a2[i];
            } else if constexpr (LX * LW == 2) {
              a0[i] = (a0[i] << 8) + a1[i];
            }
          }
          if (tile_epilogue(a0, a, m, part, epi, stages + half * C::STAGE, half, p0, tq))
            flush_rows(a, m, out, epi.obits, stages + half * C::STAGE, half);
          fresh = true;
        }
        if (!more) break;
        it = nit;
        m = nm;
        c = nc;
        t0 = nt0;
        v = nv;
        vp = nvp;
      }
    }
  }
}

template <int LX, int LW>
int launch_cfg(const CUtensorMap& map_x, const CUtensorMap& map_w, const QArgs& a, int sms,
               void* out, uint32_t* part, const IntRungEpilogue& epi, cudaStream_t stream) {
  using C = Cfg<LX, LW>;
  auto kfn = conv_q16_tc_kernel<LX, LW>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kfn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int smem = C::smem_bytes(a.win_rows, a.win_cols);
  if (smem > SMEM_LIMIT) return REPRO_BAD_ARG;
  kfn<<<a.items < sms ? a.items : sms, THREADS, smem, stream>>>(map_x, map_w, a, out, part, epi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  return launch_split_reduce<void, uint32_t>(part, out, a.n * a.ho * a.wo, a.cout, a.splits,
                                             epi, stream);
}

inline int launch_mix(int lx, int lw, const CUtensorMap& mx, const CUtensorMap& mw,
                      const QArgs& a, int sms, void* out, uint32_t* part,
                      const IntRungEpilogue& epi, cudaStream_t stream) {
  if (lx == 2 && lw == 2) return launch_cfg<2, 2>(mx, mw, a, sms, out, part, epi, stream);
  if (lx == 2) return launch_cfg<2, 1>(mx, mw, a, sms, out, part, epi, stream);
  if (lw == 2) return launch_cfg<1, 2>(mx, mw, a, sms, out, part, epi, stream);
  return launch_cfg<1, 1>(mx, mw, a, sms, out, part, epi, stream);
}

// Shared memory of a launch for the width mix.
inline int smem_for(int lx, int lw, int rows, int cols) {
  if (lx == 2 && lw == 2) return Cfg<2, 2>::smem_bytes(rows, cols);
  if (lx == 2) return Cfg<2, 1>::smem_bytes(rows, cols);
  if (lw == 2) return Cfg<1, 2>::smem_bytes(rows, cols);
  return Cfg<1, 1>::smem_bytes(rows, cols);
}

}  // namespace convq

// The fixed-point tensor-core conv on x (NHWC raws of xbits) and the
// prepared wp (launch_conv_q16_tc_prep, of wbits).  geom: conv2d.cu's 18-int
// ConvGeom, with chunk = 64 and (sub_h, sub_w) the sub-tile; ``part`` the
// (splits, N·Ho·Wo, Cout) workspace when splits > 1; out on the epilogue's
// rung (8 or 16 bits).
inline int launch_conv_q16_tc(const void* x, int xbits, const void* wp, int wbits, void* out,
                              uint32_t* part, const int* geom, int splits,
                              const IntRungEpilogue& epi, cudaStream_t stream) {
  using namespace convq;
  QArgs a{};
  a.n = geom[0], a.h = geom[1], a.w = geom[2], a.cin = geom[3];
  a.kh = geom[4], a.kw = geom[5], a.stride = geom[6], a.pad = geom[7];
  a.ho = geom[8], a.wo = geom[9], a.cout = geom[10];
  const int tau = geom[11], chunk = geom[12];
  a.tile_rows = geom[13], a.tile_cols = geom[14], a.tiles_c = geom[15];
  a.sub_h = geom[16], a.sub_w = geom[17];
  if ((xbits != 8 && xbits != 16) || (wbits != 8 && wbits != 16)) return REPRO_BAD_ARG;
  if (epi.obits != 8 && epi.obits != 16) return REPRO_BAD_ARG;
  const int lx = xbits / 8, lw = wbits / 8;
  if (chunk != CHUNK || tau != TAU) return REPRO_BAD_ARG;
  if (a.n < 1 || a.cin < 1 || (a.cin * lx) % 16 || a.cout < 8 || a.cout % 8) return REPRO_BAD_ARG;
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
  if (smem_for(lx, lw, a.win_rows, a.win_cols) > SMEM_LIMIT) return REPRO_BAD_ARG;
  a.chunks = (a.cin + CHUNK - 1) / CHUNK;
  if (splits < 1 || splits > a.chunks) return REPRO_BAD_ARG;
  a.splits = splits;
  a.per_split = (a.chunks + splits - 1) / splits;
  if ((splits - 1) * a.per_split >= a.chunks) return REPRO_BAD_ARG;  // an empty split
  if (splits > 1 && part == nullptr) return REPRO_BAD_ARG;
  a.sub_y = (a.tile_rows + a.sub_h - 1) / a.sub_h;
  a.sub_x = (a.tile_cols + a.sub_w - 1) / a.sub_w;
  a.ntau = (a.cout + TAU - 1) / TAU;
  const long long items = static_cast<long long>(splits) * a.ntau * a.n * a.tiles_r *
                          a.tiles_c * a.sub_y * a.sub_x;
  if (items > 0x7fffffffLL) return REPRO_BAD_ARG;
  a.items = static_cast<int>(items);
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wp) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(part) % 16)
    return REPRO_BAD_ARG;
  const int taps = a.kh * a.kw;
  const cuuint64_t cinp = static_cast<cuuint64_t>(a.chunks) * CHUNK;
  CUtensorMap map_x, map_w;
  const cuuint64_t bx = static_cast<cuuint64_t>(a.cin) * lx;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(a.cin), static_cast<cuuint64_t>(a.w),
                               static_cast<cuuint64_t>(a.h), static_cast<cuuint64_t>(a.n)};
  const cuuint64_t xstrides[3] = {bx, bx * a.w, bx * a.w * a.h};
  const cuuint32_t xbox[4] = {CHUNK, static_cast<cuuint32_t>(a.win_cols),
                              static_cast<cuuint32_t>(a.win_rows), 1};
  const cuuint64_t wdims[4] = {cinp, static_cast<cuuint64_t>(taps),
                               static_cast<cuuint64_t>(a.cout), static_cast<cuuint64_t>(lw)};
  const cuuint64_t wstrides[3] = {cinp, cinp * taps, cinp * taps * a.cout};
  const cuuint32_t wbox[4] = {CHUNK, 1, static_cast<cuuint32_t>(TAU),
                              static_cast<cuuint32_t>(lw)};
  const bool ok =
      make_map_4d(&map_x,
                  lx == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, x,
                  xdims, xstrides, xbox,
                  lx == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B) &&
      make_map_4d(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wp, wdims, wstrides, wbox,
                  CU_TENSOR_MAP_SWIZZLE_64B);
  if (!ok) return REPRO_BAD_ARG;
  static int sms_of[64] = {};  // SMs of each device, asked once
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return REPRO_BAD_ARG;
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = sms_of[device];
  return launch_mix(lx, lw, map_x, map_w, a, sms, out, part, epi, stream);
}

}  // namespace repro
#endif  // REPRO_CPU_SHIM
