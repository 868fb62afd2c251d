// A CPU stand-in for the CUDA runtime, enough to compile a kernel of
// xmaps_tpu_torch/csrc with g++ -std=c++20 -pthread -ffp-contract=off and
// run it on host memory: a block's threads run as std::threads with a
// std::barrier for __syncthreads, blocks one after another (so a static
// __shared__ array is each block's own), and the _rn intrinsics are single
// IEEE operations.  The launch `k<<<grid, block, 0, stream>>>(args)` is
// rewritten by the test to `cpu_launch(grid, block, k, args)`.
#pragma once
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

using std::isnan;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct cpu_uint3 { unsigned x, y, z; };
inline thread_local cpu_uint3 threadIdx, blockIdx;
inline std::barrier<>* cpu_block_barrier = nullptr;
inline void __syncthreads() { cpu_block_barrier->arrive_and_wait(); }

template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
// cvt.rzi.s32.f32: truncation, saturating, NaN -> 0
inline int __float2int_rz(float x) {
  if (std::isnan(x)) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return static_cast<int>(x);
}
inline float __int2float_rn(int i) { return static_cast<float>(i); }

template <class K, class... A>
void cpu_launch(dim3 grid, dim3 block, K kernel, A... args) {
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(n);
        cpu_block_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < n; ++t)
          threads.emplace_back([=] {
            blockIdx = {bx, by, bz};
            threadIdx = {t % block.x, (t / block.x) % block.y, t / (block.x * block.y)};
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
