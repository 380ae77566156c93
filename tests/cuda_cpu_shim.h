// CPU emulation of the CUDA subset the port's kernels use, so that
// tests/test_torch_kernels_emulated.py can run src/repro_torch/kernels/csrc
// compiled by g++ (``-include`` this header, which defines REPRO_CPU_SHIM).
// Every block of a launch runs in turn; its threads run as std::threads that
// meet at a std::barrier for __syncthreads.  Only what the kernels use is
// here; bf16 is left out (common.cuh guards it).
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
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline std::barrier<>* g_barrier = nullptr;
inline unsigned char* g_dyn_smem = nullptr;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "shim error"; }
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) { return 0; }
#define DYN_SMEM(name) unsigned char* name = g_dyn_smem
template <class F>
void shim_launch(dim3 grid, dim3 block, size_t smem, F f) {
  std::vector<unsigned char> dyn(smem + 64, 0xAB);
  g_dyn_smem = dyn.data();
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
