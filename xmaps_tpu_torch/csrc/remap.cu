// Kernel B: remap_gather -- dest[i] = src.flat[idx[i]] through a static
// packed flat index, 0 where the index is -1 (or outside the source).
//
// Replaces the TPU kernels remap_static (xmaps_tpu/ops/pallas_remap.py:411,
// call _remap_static_call :291), _remap_static_composed_call (:235) and
// remap_banded_hbm (:542), which are one contract in three TPU schedules
// (dest = where(inb & in range, src[yi, xi], 0)), and the XLA flat gather
// of the ESL back-remap (xmaps_tpu/apps/eval_esl.py:442-445).
//
// What bounds it on the H100: memory traffic.  Per destination it must
// read its index and write 4 B, plus one 4 B gather from the source.  The
// forward remap's source is the 1.2 MB camera scan, resident in L2; the
// back-remap reads the camera footprint of the box, whose rows a warp
// touches in a narrow band.  At the ESL box (1379 x 2768 forward, 640 x 480
// back) the bytes are ~35 MB a scan, ~0.011 ms at 3.35 TB/s.
//
// What the design does about it: the index maps are static (built once per
// calibration), so the host packs (yi, xi, inb) -- 9 B a destination --
// into ONE int32 flat index yi * Ws + xi, -1 for "zero" (ops/remap.py
// pack_remap_index): 4 B a destination, less than torch.take's int64.
// Each thread takes 4 consecutive destinations: one 16-byte load of 4
// indices, 4 __ldg gathers, one 16-byte float4 store; a ragged tail of
// n % 4 destinations is done by the last thread with scalar accesses.  The
// TPU kernels' band walks, host-composed layer tables and double-buffered
// HBM bands existed because a TPU gather is a serial scalar loop over VMEM;
// Hopper gathers in hardware, so none of that is carried over.
#include "common.cuh"

namespace {

__device__ __forceinline__ float gather_or_zero(const float* __restrict__ src,
                                                unsigned n_src, int i) {
  // one unsigned compare rejects -1 and anything past the source
  return static_cast<unsigned>(i) < n_src ? __ldg(src + i) : 0.0f;
}

__global__ void remap_gather_kernel(const float* __restrict__ src,
                                    unsigned n_src,
                                    const int32_t* __restrict__ idx, long n,
                                    float* __restrict__ out) {
  const long base =
      4 * (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (base + 4 <= n) {
    const int4 i4 = __ldg(reinterpret_cast<const int4*>(idx + base));
    float4 v;
    v.x = gather_or_zero(src, n_src, i4.x);
    v.y = gather_or_zero(src, n_src, i4.y);
    v.z = gather_or_zero(src, n_src, i4.z);
    v.w = gather_or_zero(src, n_src, i4.w);
    *reinterpret_cast<float4*>(out + base) = v;
  } else {
    for (long k = base; k < n; ++k) {
      out[k] = gather_or_zero(src, n_src, __ldg(idx + k));
    }
  }
}

}  // namespace

extern "C" int remap_gather(const float* src, long n_src, const int32_t* idx,
                            long n, float* out, cudaStream_t stream) {
  constexpr int threads = 256;
  if (n > 0) {
    const long quads = (n + 3) / 4;
    const unsigned blocks =
        static_cast<unsigned>((quads + threads - 1) / threads);
    remap_gather_kernel<<<blocks, threads, 0, stream>>>(
        src, static_cast<unsigned>(n_src), idx, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
