// Kernel W: warmup_add_one -- o = x + 1 over an int32 array.
//
// Replaces the TPU kernel _noop of the engine benchmark's device warm-up
// (bench.py:93-103, the same body in eval/profile_setup.py:81-90), which
// runs one trivial Pallas program on an (8, 128) int32 tile before the
// setup timer starts.  It computes what that kernel computes, so the
// benchmark's first launch (module load, context, stream) is paid before
// anything is timed.
//
// What bounds it on the H100: launch latency.  The (8, 128) tile is 4 KB
// in and 4 KB out, 2.4 ns at 3.35 TB/s; a launch costs microseconds.
//
// What the design does about it: nothing beyond one thread per element;
// the launch is the work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void warmup_add_one_kernel(const int32_t* __restrict__ x,
                                      int32_t* __restrict__ out, long n) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1;
}

}  // namespace

extern "C" int warmup_add_one(const int32_t* x, int32_t* out, long n,
                              cudaStream_t stream) {
  constexpr int threads = 256;
  const long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    warmup_add_one_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            stream>>>(x, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
