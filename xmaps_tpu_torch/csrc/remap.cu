// Kernel B: remap_gather -- dest = where(inb & in range, src[yi, xi], 0)
// through static integer index maps.
//
// Replaces the TPU kernels remap_static (xmaps_tpu/ops/pallas_remap.py:411,
// call _remap_static_call :291), _remap_static_composed_call (:235) and
// remap_banded_hbm (:542), which are one contract in three TPU schedules,
// and the XLA flat gather of the ESL back-remap
// (xmaps_tpu/apps/eval_esl.py:442-445).
//
// What bounds it on the H100: memory traffic.  Per destination pixel it
// reads 9 B of index maps and mask (coalesced) and writes 4 B, plus one
// 4 B gather from the source.  The forward remap's source is the 1.2 MB
// camera scan, resident in L2; the back-remap reads the camera footprint
// of the ~36 MB box, whose rows a warp touches in a narrow band.  At the
// ESL geometry the forward remap moves ~120 MB (the 9 Mpx box), a few tens
// of microseconds at 3.35 TB/s.
//
// What the design does about it: one thread per destination pixel with
// plain coalesced loads of the index maps and an __ldg gather.  The TPU
// kernels' band walks, host-composed layer tables and double-buffered HBM
// bands existed because a TPU gather is a serial scalar loop over VMEM;
// Hopper gathers in hardware, so none of that is carried over.
#include "common.cuh"

namespace {

__global__ void remap_gather_kernel(const float* __restrict__ src, int Hs,
                                    int Ws, const int32_t* __restrict__ yi,
                                    const int32_t* __restrict__ xi,
                                    const bool* __restrict__ inb, long n,
                                    float* __restrict__ out) {
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int y = yi[idx];
  const int x = xi[idx];
  const bool ok = (inb == nullptr || inb[idx]) && y >= 0 && y < Hs &&
                  x >= 0 && x < Ws;
  out[idx] = ok ? __ldg(src + static_cast<long>(y) * Ws + x) : 0.0f;
}

}  // namespace

extern "C" int remap_gather(const float* src, int Hs, int Ws,
                            const int32_t* yi, const int32_t* xi,
                            const bool* inb, long n, float* out,
                            cudaStream_t stream) {
  constexpr int threads = 256;
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
    remap_gather_kernel<<<blocks, threads, 0, stream>>>(src, Hs, Ws, yi, xi,
                                                        inb, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
