// CPU emulation of the CUDA subset the port's kernels use, so that
// tests/test_torch_kernels_emulated.py can run src/repro_torch/kernels/csrc
// compiled by g++ (``-include`` this header, which defines REPRO_CPU_SHIM).
// Every block of a launch runs in turn; its threads run as std::threads that
// meet at a std::barrier for __syncthreads.  A warp shuffle is an exchange
// through a per-block buffer between two barriers, so every thread of the
// block must reach it together (the kernels shuffle uniformly).  Only what
// the kernels use is here; bf16, and with it the float GEMM's wgmma route,
// is left out (common.cuh and gemm_wgmma.cuh guard them).
#pragma once
#define REPRO_CPU_SHIM 1
#include <math.h>
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// 16-byte vectors: what the kernels' vector loads read (alignas keeps the
// kernels' alignment assumptions checkable here)
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline std::barrier<>* g_barrier = nullptr;
inline unsigned char* g_dyn_smem = nullptr;
inline float* g_shfl = nullptr;  // one slot per thread of the running block
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
// 1-D blocks: the lane partner of thread t is t ^ lane_mask (lane_mask < 32)
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const unsigned t = threadIdx.x;
  g_shfl[t] = v;
  __syncthreads();
  const float r = g_shfl[t ^ static_cast<unsigned>(lane_mask)];
  __syncthreads();
  return r;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "shim error"; }
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return 0; }
#define DYN_SMEM(name) unsigned char* name = g_dyn_smem
template <class F>
void shim_launch(dim3 grid, dim3 block, size_t smem, F f) {
  std::vector<unsigned char> dyn(smem + 64, 0xAB);
  g_dyn_smem = dyn.data();
  std::vector<float> shfl(block.x * block.y * block.z);
  g_shfl = shfl.data();
  gridDim = grid;
  blockDim = block;
  const int nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(nt);
        g_barrier = &bar;
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by, bz);
            f();
          });
        for (auto& th : ts) th.join();
      }
}
#define LAUNCH(kernel, grid, block, smem, stream, ...) \
  shim_launch(grid, block, smem, [&] { kernel(__VA_ARGS__); })
