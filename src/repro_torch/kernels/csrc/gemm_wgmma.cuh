// Route W of the float GEMM: bf16 on the tensor cores, for m > 16.
//
// Replaces, with gemm_splitk.cuh and gemm.cuh, the TPU kernel
// repro/kernels/matmul_fp.py:_mm_kernel (via matmul_fp_pallas) for the
// prefill's GEMMs: m = 4 x 4096 tokens, k and n from 128 to 4864.
//
// What bounds it on an H100: 2·m·n·k operations at 989 TFLOP/s of dense
// bf16 (the gate / up projection, 143 GFLOP: 0.144 ms), far above its bytes
// (0.05 ms).  Only wgmma reaches that rate, and wgmma only as fast as its
// operands arrive in shared memory.  The design:
//   * a block owns a 128 x BN output tile (BN 128 or 256) and walks k in
//     64-deep steps; two consumer warpgroups each own 64 of its rows and
//     issue wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulators in
//     registers: 64 or 128 floats a thread), one step's wgmmas in flight
//     while they wait for the step before;
//   * one producer warpgroup (its first thread issues, setmaxnreg gives the
//     others' registers to the consumers) keeps a ring of shared-memory
//     stages (6, or 4 for BN 256: 192 KB) full with TMA
//     (cp.async.bulk.tensor.2d) loads in the 128-byte swizzle wgmma reads;
//     each stage has a full
//     mbarrier (TMA completes its bytes there) and an empty one (each
//     consumer arrives when its wgmmas on the stage are done), so loads run
//     ahead of math;
//   * the kernel is persistent, one block an SM walking the tiles, so the
//     producer's loads for the next tile run under this tile's epilogue;
//   * A is x, (m, k) row-major: K-major.  B is w: a (k, n) row-major w is
//     MN-major (wgmma's transpose-B flag), loaded as BN / 64 boxes of
//     64 (n) x 64 (k); the transposed view embed.T is an (n, k) row-major
//     matrix, K-major, one box of BN x 64;
//   * TMA zero-fills rows and columns past the matrix, so ragged m, n and k
//     need no masks on the loads; the epilogue (common.cuh's
//     FloatEpilogue: bias, ReLU, fake-quant, bf16) runs on the accumulator
//     registers, stages the bf16 tile 64 columns at a time in two swizzled
//     shared-memory boxes, and one thread stores each with TMA (rows and
//     columns past the matrix are not written), which runs on under the
//     next tile's loads and math;
//   * tiles are numbered in groups of 16 m-tiles, so the tiles in flight
//     at one time share their x rows and w columns in L2.
// TMA needs 16-byte row strides (k and n multiples of 8) and 16-byte
// aligned bases: the planner sends other shapes to route L, and the wrapper
// refuses unaligned pointers.  The CUtensorMap comes from
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint, so the
// library does not link libcuda.
//
// All of it is inline PTX for sm_90a, so none of it exists under the CPU
// shim (REPRO_CPU_SHIM): the CPU tests cannot run this route.
#pragma once

#ifndef REPRO_CPU_SHIM
#include <cuda.h>

#include "common.cuh"

namespace repro {
namespace wgmma {

constexpr int BM = 128;      // output rows of a block: two consumer warpgroups of 64
constexpr int BK = 64;       // k per stage: 64 bf16 = one 128-byte swizzle row
constexpr int THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr int GROUP_M = 16;  // m-tiles per group of the tile order

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box into shared memory; its bytes complete on ``bar``.  c0 is the
// coordinate along the contiguous dimension, c1 along the rows.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One TMA box from shared memory to the matrix (rows and columns past its
// edges are not written), in this thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of wgmmas are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32 in registers) += A (64 x 16) . B (16 x 128), bf16 from shared
// memory through descriptors; TNSP_B = 1 reads B MN-major (a (k, n) row-major w).
template <int TNSP_B>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TNSP_B));
}

// D (64 x 256, f32 in registers) += A (64 x 16) . B (16 x 256), bf16 from shared
// memory through descriptors; TNSP_B = 1 reads B MN-major (a (k, n) row-major w).
template <int TNSP_B>
__device__ __forceinline__ void mma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TNSP_B));
}

template <int BN, int TNSP_B>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) {
    mma_m64n128k16<TNSP_B>(d, da, db);
  } else {
    mma_m64n256k16<TNSP_B>(d, da, db);
  }
}

// ring stages: 192 KB of operands in flight either way, beside the epilogue's
// 32 KB, inside the 227 KB a block may take
template <int BN>
__host__ __device__ constexpr int stages() {
  return BN == 256 ? 4 : 6;
}

constexpr int BOX = 64 * 64 * 2;  // one 64 x 64 bf16 output box, 128-byte swizzled

template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  // the ring, two output boxes a consumer, alignment slack, the barriers
  return stages<BN>() * (BM + BN) * BK * 2 + 4 * BOX + 1024 + stages<BN>() * 16;
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

// Persistent: each block walks tiles blockIdx.x, + gridDim.x, ...; the
// producer runs ahead across tile boundaries, so the next tile's loads
// overlap this tile's epilogue.  TB: w is an (n, k) row-major matrix
// (K-major B); otherwise (k, n) row-major (MN-major B).
template <int BN, bool TB>
__global__ void __launch_bounds__(THREADS, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_out, int m, int n, int k,
                 FloatEpilogue epi) {
  constexpr int S = stages<BN>();
  constexpr int A_BYTES = BM * BK * 2;
  constexpr int B_BYTES = BN * BK * 2;
  constexpr int STAGE = A_BYTES + B_BYTES;
  DYN_SMEM(raw);
  // the 128-byte swizzle repeats every 1024 bytes: stages start on that grid
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  // the epilogue's output boxes: two a consumer, used in turn
  unsigned char* epi_tile = base + S * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi_tile + 4 * BOX);
  uint64_t* empty = full + S;

  const int mtiles = (m + BM - 1) / BM, ntiles = (n + BN - 1) / BN;
  const int tiles = mtiles * ntiles;
  const int ksteps = (k + BK - 1) / BK;
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
          mbar_expect_tx(&full[s], STAGE);
          unsigned char* sa = base + s * STAGE;
          unsigned char* sb = sa + A_BYTES;
          tma_load(sa, &map_x, &full[s], kt * BK, m0);
          if (TB) {
            tma_load(sb, &map_w, &full[s], kt * BK, n0);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(sb + j * 64 * BK * 2, &map_w, &full[s], n0 + 64 * j, kt * BK);
          }
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
    unsigned char* mine = epi_tile + half * 2 * BOX;
    float acc[BN / 2];
    int s = 0, phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_origin(t, mtiles, ntiles, BN, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int kt = 0; kt < ksteps; ++kt) {
        mbar_wait(&full[s], phase);
        const unsigned char* sa = base + s * STAGE + half * 64 * BK * 2;
        const unsigned char* sb = base + s * STAGE + A_BYTES;
        // K-major: 8-row groups 1024 bytes apart, a k16 step is 32 bytes on;
        // MN-major: 64-column boxes 64·BK·2 bytes apart, k16 is 16 rows on
        const uint64_t da = smem_desc(sa, 16, 1024);
        const uint64_t db = TB ? smem_desc(sb, 16, 1024) : smem_desc(sb, 64 * BK * 2, 1024);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma<BN, TB ? 0 : 1>(acc, da + kk * 2, db + (TB ? kk * 2 : kk * 16 * 128 / 16));
        wgmma_commit();
        // keep this step's wgmmas in flight; the previous step's are done,
        // so its stage goes back to the producer
        wgmma_wait<1>();
        fence_regs(acc);
        if (prev >= 0 && t128 == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (t128 == 0) mbar_arrive(&empty[prev]);

      // epilogue: this consumer's 64 x BN tile goes out as BN / 64 boxes of
      // 64 x 64 bf16, each staged in one of two swizzled buffers and stored
      // by one thread with TMA (rows and columns past the matrix are not
      // written); the stores run on under the next tile's loads and math.
      // Accumulator layout of m64nN: register 4j + 2h + e holds row
      // 16·warp + lane/4 + 8h, column 8j + 2·(lane%4) + e.
      const int r0 = (t128 / 32) * 16 + (t128 % 32) / 4;
#pragma unroll
      for (int q = 0; q < BN / 64; ++q) {
        unsigned char* box = mine + (q % 2) * BOX;
        // each box is a bulk group of its own: with at most one pending,
        // the store that last read this buffer is done
        if (t128 == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + half) : "memory");
#pragma unroll
        for (int j = 8 * q; j < 8 * q + 8; ++j) {
          const int c = 8 * j + 2 * (t128 % 4);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            __nv_bfloat162 v;
            v.x = epi.template apply<__nv_bfloat16>(acc[4 * j + 2 * h], min(n0 + c, n - 1));
            v.y = epi.template apply<__nv_bfloat16>(acc[4 * j + 2 * h + 1],
                                                    min(n0 + c + 1, n - 1));
            // row r's 16-byte chunk (c % 64) / 8 lands at chunk ^ (r % 8)
            const int chunk = ((c % 64) / 8) ^ (r % 8);
            *reinterpret_cast<__nv_bfloat162*>(box + r * 128 + chunk * 16 + (c % 8) * 2) = v;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + half) : "memory");
        if (t128 == 0) {
          tma_store(&map_out, box, n0 + 64 * q, m0 + half * 64);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      }
    }
    if (t128 == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rows x cols row-major bf16 matrix, read in boxes of box_rows x 64
// columns (128 bytes) with the 128-byte swizzle; zero fill past its edges.
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estride[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool TB>
int launch_tile(const CUtensorMap& map_x, const CUtensorMap& map_w,
                const CUtensorMap& map_out, int m, int n, int k, int sms,
                const FloatEpilogue& epi, cudaStream_t stream) {
  auto kfn = wgmma_kernel<BN, TB>;
  constexpr int smem = smem_bytes<BN>();
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
  kfn<<<grid, THREADS, smem, stream>>>(map_x, map_w, map_out, m, n, k, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma

// Route W on bf16 x (m, k) and w: (k, n) row-major, or (n, k) row-major
// when trans_b; tile (bm, bn, bk) one of (128, 128, 64), (128, 256, 64).
inline int launch_wgmma(const void* x, const void* w, void* out, int m, int n, int k,
                        int trans_b, int bm, int bn, int bk, const FloatEpilogue& epi,
                        cudaStream_t stream) {
  using namespace wgmma;
  if (bm != BM || bk != BK || (bn != 128 && bn != 256)) return REPRO_BAD_ARG;
  if (k % 8 != 0 || n % 8 != 0) return REPRO_BAD_ARG;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return REPRO_BAD_ARG;
  if (reinterpret_cast<uintptr_t>(out) % 16) return REPRO_BAD_ARG;
  CUtensorMap map_x, map_w, map_out;
  if (!make_map(&map_x, x, m, k, BM) || !make_map(&map_out, out, m, n, 64))
    return REPRO_BAD_ARG;
  const bool ok = trans_b ? make_map(&map_w, w, n, k, bn) : make_map(&map_w, w, k, n, BK);
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
  if (bn == 128)
    return trans_b ? launch_tile<128, true>(map_x, map_w, map_out, m, n, k, sms, epi, stream)
                   : launch_tile<128, false>(map_x, map_w, map_out, m, n, k, sms, epi, stream);
  return trans_b ? launch_tile<256, true>(map_x, map_w, map_out, m, n, k, sms, epi, stream)
                 : launch_tile<256, false>(map_x, map_w, map_out, m, n, k, sms, epi, stream);
}

}  // namespace repro
#endif  // REPRO_CPU_SHIM
