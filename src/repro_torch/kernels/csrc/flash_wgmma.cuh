// Route wgmma of flash attention: QKᵀ and PV on the tensor cores in
// split-precision bf16, for sm_90a, at head dims 64 and 128.
//
// Replaces, with flash_attention.cu's CUDA-core kernel (route simt, head
// dims 16 and 32), the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (kernel _fa_kernel) and the kv broadcast of
// repro/kernels/ops.py:flash_attention.  The function is the reference's:
// an f32 running max, denominator and accumulator per row, masked scores at
// -1e30, kv tiles wholly above the diagonal skipped, p rounded to v's dtype
// before p·v, and acc / max(l, 1e-30) written in q's dtype; key columns past
// Sk are masked too.
//
// What bounds it on an H100: at the serving shape (q (4, 16, 4096, 64), kv
// (4, 2, 4096, 64), causal) the work is 137.5 GFLOP against 0.15 GB, so
// operations bound it.  The model's chunked route hands the kernel f32 q, k
// and v, and the reference holds the kernel to 2e-3: one bf16 pass rounds
// each operand to 8 significant bits, which scores of |s| ~ 20 carry through
// the exponent past that.  So each f32 operand is split, x = hi + lo with
// hi = bf16_rn(x) and lo = bf16_rn(x - hi) (about 16 significant bits), and
// each product is issued as three bf16 products into an f32 accumulator,
// hi·lo, lo·hi, then hi·hi; the dropped lo·lo term is below 2^-16 of the
// product.  Three bf16 products run at 989 / 3 = 330 TFLOP/s: 0.417 ms of
// them at that shape, against 2.052 ms at the CUDA cores' f32 rate.  bf16
// operands are exact in one plane, and the reference rounds p to bf16
// there, so that dtype runs one product per GEMM.
//
// The design:
//   * a preparation launch per call (flash_prep_kernel) reads the strided
//     q / k / v views (contiguous head dim) and writes dense (B·H·S, D)
//     bf16 planes, hi then lo (hi only for bf16), which TMA can address;
//   * a block owns 128 q rows of one (batch, q head): two consumer
//     warpgroups of 64 rows each, and one producer warpgroup whose first
//     thread loads the Q planes once and keeps a ring of STAGES K / V tiles
//     (both planes) full with TMA in the 128-byte swizzle (setmaxnreg gives
//     the producer's registers to the consumers).  Each stage has a full
//     mbarrier (TMA completes its bytes there) and an empty one (every
//     consumer warp arrives when its wgmmas on the stage are done).  The kv
//     head is read in place for every q head of its group (h / G);
//   * S = QKᵀ: A is the Q planes from shared memory, K-major; B is the K
//     tile, (keys, D) row-major, which is K-major too; m64nBKk16 wgmmas,
//     three per k16 step (one for bf16), into an accumulator zeroed per
//     tile: a chain only 3·D/16 deep;
//   * softmax on the CUDA cores: scale (log2(e) folded in, exp2f), mask only
//     on the tiles that the diagonal or Sk cuts, row max and sum over the 4
//     lanes that share a row;
//   * PV: p leaves the S accumulator registers as bf16 register-A fragments
//     (the m64nN f32 accumulator layout is the m64nNk16 A layout, so no
//     shuffle), p_hi and, for f32, p_lo = bf16(p - p_hi); B is the V tile,
//     (keys, D) row-major, MN-major, through wgmma's transpose-B flag.  Each
//     tile's PV goes into a fresh accumulator that is added to the rescaled
//     O on the CUDA cores (the tensor cores' f32 accumulator truncates its
//     adds, so a chain over all kv tiles would drift), and the p fragments
//     are not rewritten until the PV group has been waited for (a
//     register-A wgmma reads its registers until then);
//   * the grid is (B·Hq, q tiles), the heaviest q tiles of every head first.
// TMA needs 16-byte rows and bases: the planes are dense and allocated by
// the wrapper, and the preparation pass reads 16 bytes at a time, so the
// views' rows must be 16-byte aligned, which the launcher checks.
//
// All of it is inline PTX for sm_90a, so none of it exists under the CPU
// shim (REPRO_CPU_SHIM): the CPU tests cannot run this route.
#pragma once

#ifndef REPRO_CPU_SHIM
#include "hopper.cuh"

namespace repro {
namespace fawg {

using namespace hopper;

constexpr int BQ = 128;      // q rows of a block: two consumer warpgroups of 64
constexpr int THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr int STAGES = 2;    // K / V tiles in flight
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// keys of a kv tile: 128 at D 64 (S is m64n128), 64 at D 128
template <int D>
__host__ __device__ constexpr int bk() {
  return D == 64 ? 128 : 64;
}
// bf16 planes of an operand: hi and lo for f32, hi alone for bf16
template <typename T>
__host__ __device__ constexpr int planes() {
  return sizeof(T) == 4 ? 2 : 1;
}
// one plane of the Q tile, of a K or V tile: D / 64 boxes of rows x 128 bytes
template <int D>
__host__ __device__ constexpr int q_plane() {
  return BQ * D * 2;
}
template <int D>
__host__ __device__ constexpr int kv_plane() {
  return bk<D>() * D * 2;
}
template <typename T, int D>
__host__ __device__ constexpr int smem_bytes() {
  // alignment slack, the Q tile, the K / V ring, the barriers
  return 1024 + planes<T>() * (q_plane<D>() + STAGES * 2 * kv_plane<D>()) +
         (1 + 2 * STAGES) * 8;
}

// D (64 x 64, f32 in registers) += A (64 x 16, bf16 from shared memory, K-major)
// . B (16 x 64, bf16 from shared memory, K-major), through descriptors.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, f32 in registers) += A (64 x 16, bf16 in registers: the m64nNk16
// fragment, four 32-bit registers of two values) . B (16 x 64, bf16 from shared
// memory, MN-major: wgmma's transpose-B flag), through its descriptor.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32 in registers) += A (64 x 16, bf16 in registers: the m64nNk16
// fragment, four 32-bit registers of two values) . B (16 x 128, bf16 from shared
// memory, MN-major: wgmma's transpose-B flag), through its descriptor.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128) {
    mma_m64n128k16<0>(d, da, db);  // hopper.cuh's, shared with the GEMM
  } else {
    mma_ss_n64(d, da, db);
  }
}
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db) {
  if constexpr (N == 128) {
    mma_rs_n128(d, a, db);
  } else {
    mma_rs_n64(d, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 x, __nv_bfloat16 y) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(y)) << 16);
}

// Two f32 values -> their bf16 hi pair and lo pair: hi = bf16_rn(x), lo =
// bf16_rn(x - hi), x first (the lower half of each register).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = pack_bf16(hx, hy);
  lo = pack_bf16(__float2bfloat16_rn(x - __bfloat162float(hx)),
                 __float2bfloat16_rn(y - __bfloat162float(hy)));
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

struct FaArgs {
  int hq, group, sq, sk;
  long long rows_q, rows_kv;  // rows of one plane of Q, of K and of V
  long long ob, oh, os;       // element strides of out's (batch, head, seq) axes
  int causal, q_offset;
  float scale_log2;           // d^-1/2 · log2(e)
};

// The product pairs (A plane, B plane) of one GEMM: hi·lo, lo·hi, hi·hi for
// f32 (the small terms first), hi·hi for bf16.
template <int P>
__device__ __forceinline__ int plane_a(int pass) {
  return P == 2 && pass == 1 ? 1 : 0;
}
template <int P>
__device__ __forceinline__ int plane_b(int pass) {
  return P == 2 && pass == 0 ? 1 : 0;
}

// Grid (B·Hq, q tiles); blockIdx.y = 0 is each head's last (heaviest) tile.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, T* __restrict__ out,
                          FaArgs a) {
  constexpr int P = planes<T>();
  constexpr int BK = bk<D>();
  constexpr int QP = q_plane<D>();
  constexpr int KP = kv_plane<D>();
  constexpr int STAGE = 2 * P * KP;  // a K tile then a V tile, every plane
  DYN_SMEM(raw);
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = qs + P * QP;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / a.hq, h = bh % a.hq, hk = h / a.group;
  const int n_qt = (a.sq + BQ - 1) / BQ;
  const int r0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  // kv tiles with a first column at or before this block's last row
  int n_kt = (a.sk + BK - 1) / BK;
  if (a.causal) n_kt = min(n_kt, (a.q_offset + min(r0 + BQ, a.sq) - 1) / BK + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer warpgroup: one thread loads Q, then keeps the K / V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const int q_row = static_cast<int>(static_cast<long long>(bh) * a.sq + r0);
      const int kv_row = static_cast<int>((static_cast<long long>(b) * (a.hq / a.group) + hk) *
                                          a.sk);
      mbar_expect_tx(q_full, P * QP);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          tma_load(qs + p * QP + x * BQ * 128, &map_q, q_full, 64 * x,
                   static_cast<int>(p * a.rows_q) + q_row);
      int s = 0, phase = 0;
      for (int t = 0; t < n_kt; ++t) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], STAGE);
        unsigned char* ks = ring + s * STAGE;
        unsigned char* vs = ks + P * KP;
        const int row = kv_row + t * BK;
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            const int r = static_cast<int>(p * a.rows_kv) + row;
            tma_load(ks + p * KP + x * BK * 128, &map_k, &full[s], 64 * x, r);
            tma_load(vs + p * KP + x * BK * 128, &map_v, &full[s], 64 * x, r);
          }
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: rows 64 (wg - 1) .. 64 wg - 1 of the block's tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int half = wg - 1;
    const int t128 = threadIdx.x % 128;
    const int warp = t128 / 32, lane = t128 % 32;
    const int g = lane / 4, tq = lane % 4;
    const int w0 = r0 + half * 64;            // this warpgroup's first row
    const int w_last = min(w0 + 63, a.sq - 1);  // its last real row (< w0: none)
    // the tiles this warpgroup needs; it still takes part in the others' barriers
    int w_kt = w_last < w0 ? 0 : n_kt;
    if (a.causal && w_kt) w_kt = min(n_kt, (a.q_offset + w_last) / BK + 1);
    // accumulator layout of m64nN: register 4j + 2h + e holds row
    // 16·warp + g + 8h, column 8j + 2·tq + e
    const int row0 = a.q_offset + w0 + 16 * warp + g;  // global position of row h = 0
    float o[D / 2], m[2], l[2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.0f;
    const unsigned char* q_mine = qs + half * 64 * 128;
    mbar_wait(q_full, 0);

    int s = 0, phase = 0;
    for (int t = 0; t < n_kt; ++t) {
      mbar_wait(&full[s], phase);
      if (t < w_kt) {
        const unsigned char* ks = ring + s * STAGE;
        const unsigned char* vs = ks + P * KP;
        const int c0 = t * BK;

        // S = Q Kᵀ: D / 16 k-steps of each product pair; a k-step is 32
        // bytes on inside a 64-column box (2 in descriptor units)
        float sc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int pass = 0; pass < (P == 2 ? 3 : 1); ++pass) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint64_t da =
                smem_desc(q_mine + plane_a<P>(pass) * QP + (kk / 4) * BQ * 128, 16, 1024);
            const uint64_t db =
                smem_desc(ks + plane_b<P>(pass) * KP + (kk / 4) * BK * 128, 16, 1024);
            mma_ss<BK>(sc, da + (kk % 4) * 2, db + (kk % 4) * 2);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // online softmax in the log2 domain, on the CUDA cores
        const bool cut = c0 + BK > a.sk || (a.causal && c0 + BK - 1 > a.q_offset + w0);
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = row0 + 8 * hh;
          float mx = NEG;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& v = sc[4 * j + 2 * hh + e];
              v *= a.scale_log2;
              if (cut) {
                const int col = c0 + 8 * j + 2 * tq + e;
                if (col >= a.sk || (a.causal && row < col)) v = NEG;
              }
              mx = fmaxf(mx, v);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[hh], mx);
          alpha[hh] = exp2f(m[hh] - m_new);
          m[hh] = m_new;
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& v = sc[4 * j + 2 * hh + e];
              v = exp2f(v - m_new);
              sum += v;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l[hh] = l[hh] * alpha[hh] + sum;
        }

        // p as register-A fragments (hi, and lo for f32), four registers a
        // k16 step of keys: (row g, keys 2tq..), (row g + 8, ..), (row g,
        // keys 8 + 2tq..), (row g + 8, ..) are accumulator pairs 8kk, 8kk + 2,
        // 8kk + 4, 8kk + 6, so register i packs accumulators 2i and 2i + 1
        uint32_t ph[BK / 4], pl[BK / 4];
#pragma unroll
        for (int i = 0; i < BK / 4; ++i) split_pair(sc[2 * i], sc[2 * i + 1], ph[i], pl[i]);

        // PV into a fresh accumulator: V's k16 step is 16 rows of 128 bytes
        // (128 in descriptor units); its 64-column boxes lie BK·128 bytes apart
        float pv[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) pv[i] = 0.0f;
        const uint64_t dv_hi = smem_desc(vs, BK * 128, 1024);
        const uint64_t dv_lo = smem_desc(vs + (P - 1) * KP, BK * 128, 1024);
        fence_regs(pv);
        fence_regs(ph);
        if constexpr (P == 2) fence_regs(pl);
        wgmma_fence();
        if constexpr (P == 2) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(pv, ph + 4 * kk, dv_lo + kk * 128);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(pv, pl + 4 * kk, dv_hi + kk * 128);
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(pv, ph + 4 * kk, dv_hi + kk * 128);
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            o[4 * j + 2 * hh] *= alpha[hh];
            o[4 * j + 2 * hh + 1] *= alpha[hh];
          }
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(ph);
        if constexpr (P == 2) fence_regs(pl);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] += pv[i];
      }
      // every consumer warp hands the stage back, used or not
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }

    // write-back: acc / max(l, 1e-30) in out's dtype, rows past Sq not written
    T* op = out + b * a.ob + h * a.oh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = w0 + 16 * warp + g + 8 * hh;
      if (r >= a.sq) continue;
      const float den = fmaxf(l[hh], 1e-30f);
      T* orow = op + r * a.os;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair(orow + 8 * j + 2 * tq, o[4 * j + 2 * hh] / den, o[4 * j + 2 * hh + 1] / den);
    }
  }
}

struct PrepArgs {
  int hq, hkv, sq, sk, d;
  long long rows_q, rows_kv;
  long long st[9];  // element strides of the (batch, head, seq) axes of q, k, v
};

// Eight values of a row: two 16-byte loads of f32, one of bf16.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// q, k, v (strided views, contiguous head dim) -> the dense bf16 planes
// qp (P, B·Hq·Sq, D), kp and vp (P, B·Hkv·Sk, D): hi = bf16_rn(x), and for
// f32 lo = bf16_rn(x - hi).  blockIdx.y picks the operand (q, k, v); each
// thread writes 8 values (16 bytes) a plane.  32-bit indices: the launcher
// bounds the rows.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_attention_prep(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, __nv_bfloat16* __restrict__ qp,
                         __nv_bfloat16* __restrict__ kp, __nv_bfloat16* __restrict__ vp,
                         PrepArgs a) {
  constexpr int P = planes<T>();
  const int which = blockIdx.y;
  const T* src = which == 0 ? q : which == 1 ? k : v;
  __nv_bfloat16* dst = which == 0 ? qp : which == 1 ? kp : vp;
  const int rows = static_cast<int>(which == 0 ? a.rows_q : a.rows_kv);
  const int heads = which == 0 ? a.hq : a.hkv, seq = which == 0 ? a.sq : a.sk;
  // the operand's strides, picked by value (an indexed kernel parameter
  // would be copied to local memory)
  const long long sb = which == 0 ? a.st[0] : which == 1 ? a.st[3] : a.st[6];
  const long long sh = which == 0 ? a.st[1] : which == 1 ? a.st[4] : a.st[7];
  const long long sr = which == 0 ? a.st[2] : which == 1 ? a.st[5] : a.st[8];
  const int per_row = a.d / 8;
  const int total = rows * per_row;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total; i += gridDim.x * 256) {
    const int row = i / per_row, c = (i % per_row) * 8;
    const int ss = row % seq, bh = row / seq;
    const int hh = bh % heads, bb = bh / heads;
    float x[8];
    load8(src + bb * sb + hh * sh + ss * sr + c, x);
    uint4 hi, lo;
    split_pair(x[0], x[1], hi.x, lo.x);
    split_pair(x[2], x[3], hi.y, lo.y);
    split_pair(x[4], x[5], hi.z, lo.z);
    split_pair(x[6], x[7], hi.w, lo.w);
    const size_t at = static_cast<size_t>(row) * a.d + c;
    *reinterpret_cast<uint4*>(dst + at) = hi;
    if (P == 2) *reinterpret_cast<uint4*>(dst + static_cast<size_t>(rows) * a.d + at) = lo;
  }
}

template <typename T, int D>
int launch_d(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out,
             int batch, const FaArgs& a, int plan_bk, int plan_smem, cudaStream_t stream) {
  auto kfn = flash_attention_wgmma<T, D>;
  constexpr int smem = smem_bytes<T, D>();
  if (plan_bk != bk<D>() || plan_smem != smem) return REPRO_BAD_ARG;  // the planner's copy
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kfn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(batch * a.hq, (a.sq + BQ - 1) / BQ);
  kfn<<<grid, THREADS, smem, stream>>>(mq, mk, mv, static_cast<T*>(out), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool aligned16(const void* p, const long long* st, int n) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < n; ++i)
    if ((st[i] * static_cast<long long>(sizeof(T))) % 16) return false;
  return true;
}

template <typename T>
int prep(const void* q, const void* k, const void* v, void* qp, void* kp, void* vp,
         const PrepArgs& a, cudaStream_t stream) {
  if (!aligned16<T>(q, a.st, 3) || !aligned16<T>(k, a.st + 3, 3) ||
      !aligned16<T>(v, a.st + 6, 3))
    return REPRO_BAD_ARG;
  const long long chunks = (a.rows_q > a.rows_kv ? a.rows_q : a.rows_kv) * (a.d / 8);
  if (chunks + 256LL * 65536 * 16 > 0x7fffffffLL) return REPRO_BAD_ARG;  // 32-bit indices
  const long long blocks = (chunks + 255) / 256;
  const dim3 grid(static_cast<unsigned>(blocks < 65536 * 16 ? blocks : 65536 * 16), 3);
  flash_attention_prep<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<__nv_bfloat16*>(qp), static_cast<__nv_bfloat16*>(kp),
      static_cast<__nv_bfloat16*>(vp), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fawg

// The preparation pass: q (B, Hq, Sq, D), k / v (B, Hkv, Sk, D), strided
// with a contiguous head dim and 16-byte aligned rows -> the dense bf16
// planes qp (P, B·Hq·Sq, D), kp, vp (P, B·Hkv·Sk, D); P = 2 for f32
// (dtype 0), 1 for bf16 (dtype 1).
inline int launch_flash_prep(const void* q, const void* k, const void* v, void* qp, void* kp,
                             void* vp, int batch, int hq, int hkv, int sq, int sk, int d,
                             int dtype, const long long* strides, cudaStream_t stream) {
  if (d % 8 || d < 8) return REPRO_BAD_ARG;
  if (reinterpret_cast<uintptr_t>(qp) % 16 || reinterpret_cast<uintptr_t>(kp) % 16 ||
      reinterpret_cast<uintptr_t>(vp) % 16)
    return REPRO_BAD_ARG;
  fawg::PrepArgs a{};
  a.hq = hq, a.hkv = hkv, a.sq = sq, a.sk = sk, a.d = d;
  a.rows_q = static_cast<long long>(batch) * hq * sq;
  a.rows_kv = static_cast<long long>(batch) * hkv * sk;
  for (int i = 0; i < 9; ++i) a.st[i] = strides[i];
  if (dtype == 0) return fawg::prep<float>(q, k, v, qp, kp, vp, a, stream);
  if (dtype == 1) return fawg::prep<__nv_bfloat16>(q, k, v, qp, kp, vp, a, stream);
  return REPRO_BAD_ARG;
}

// Route wgmma on the planes of launch_flash_prep: out (B, Hq, Sq, D) in the
// operands' dtype, with the element strides of its first three axes in
// out_strides and a contiguous last axis; d 64 or 128.  plan_bk and
// plan_smem are core/dse.py:plan_flash's kv tile and shared memory, which
// must be this header's bk<D>() and smem_bytes<T, D>().
inline int launch_flash_wgmma(const void* qp, const void* kp, const void* vp, void* out,
                              int batch, int hq, int hkv, int sq, int sk, int d, int dtype,
                              const long long* out_strides, int causal, int q_offset,
                              float scale, int plan_bk, int plan_smem, cudaStream_t stream) {
  using namespace fawg;
  if (d != 64 && d != 128) return REPRO_BAD_ARG;
  if (dtype != 0 && dtype != 1) return REPRO_BAD_ARG;
  const int p = dtype == 0 ? 2 : 1;
  FaArgs a{};
  a.hq = hq, a.group = hq / hkv, a.sq = sq, a.sk = sk;
  a.rows_q = static_cast<long long>(batch) * hq * sq;
  a.rows_kv = static_cast<long long>(batch) * hkv * sk;
  a.ob = out_strides[0], a.oh = out_strides[1], a.os = out_strides[2];
  a.causal = causal, a.q_offset = q_offset, a.scale_log2 = scale * LOG2E;
  // TMA's row coordinates are 32-bit; out is written in pairs
  if (p * (a.rows_q + BQ) > 0x7fffffffLL || p * (a.rows_kv + 128) > 0x7fffffffLL)
    return REPRO_BAD_ARG;
  if (static_cast<long long>(batch) * hq > 0x7fffffffLL || (sq + BQ - 1) / BQ > 65535)
    return REPRO_BAD_ARG;
  const size_t esize = dtype == 0 ? 4 : 2;
  if (reinterpret_cast<uintptr_t>(out) % (2 * esize) || a.ob % 2 || a.oh % 2 || a.os % 2)
    return REPRO_BAD_ARG;
  if (reinterpret_cast<uintptr_t>(qp) % 16 || reinterpret_cast<uintptr_t>(kp) % 16 ||
      reinterpret_cast<uintptr_t>(vp) % 16)
    return REPRO_BAD_ARG;
  const int kv_box = d == 64 ? bk<64>() : bk<128>();
  CUtensorMap mq, mk, mv;
  if (!make_map_2d(&mq, qp, p * a.rows_q, d, BQ) ||
      !make_map_2d(&mk, kp, p * a.rows_kv, d, kv_box) ||
      !make_map_2d(&mv, vp, p * a.rows_kv, d, kv_box))
    return REPRO_BAD_ARG;
  const int pb = plan_bk, ps = plan_smem;
  if (dtype == 0)
    return d == 64 ? launch_d<float, 64>(mq, mk, mv, out, batch, a, pb, ps, stream)
                   : launch_d<float, 128>(mq, mk, mv, out, batch, a, pb, ps, stream);
  return d == 64 ? launch_d<__nv_bfloat16, 64>(mq, mk, mv, out, batch, a, pb, ps, stream)
                 : launch_d<__nv_bfloat16, 128>(mq, mk, mv, out, batch, a, pb, ps, stream);
}

}  // namespace repro
#endif  // REPRO_CPU_SHIM
