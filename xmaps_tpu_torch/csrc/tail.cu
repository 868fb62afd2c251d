// Kernels 2 and 3: the dense per-frame image tail.
//
// tail_projector replaces pallas_tail (xmaps_tpu/ops/pallas_tail.py:851,
// body _tail_core :453): packed crop map -> unpack -> 7x7 max dilate ->
// nearest remap through the i16 projector maps (0 out of bounds) -> depth ->
// u8 -> TURBO.  colorize_camera replaces pallas_colorize (:777, body
// _colorize_core :736): the camera view, unpack -> depth -> u8 -> TURBO.
//
// What bounds them on the H100: memory traffic and, for the projector tail,
// gather latency.  Per projector pixel the tail reads 4 B of maps and a 7x7
// window of the packed map (49 x 4 B, mostly L2/L1 hits: neighbouring output
// pixels read overlapping windows of the ~2.3 MB crop) and writes 4 B of
// packed BGR (or 3 B of BGR plus 8 B of f32 depth/disp).  At the
// demonstrator's 0.92 Mpx that is under 20 MB of DRAM traffic, a few
// microseconds at 3.35 TB/s; the window reads are what the SMs spend time on.
//
// What the design does about it: one thread per output pixel, no shared
// memory.  The TPU kernel's band DMAs, yhat row-alignment stripes and tile
// ladder existed because a TPU gather is a serial scalar loop; Hopper
// gathers in hardware, so the kernel dilates exactly the one window each
// output pixel samples (bit-exact with dilating the whole map: the crop
// carries the 3-px halo, disparities are >= 0, and the window always holds
// its in-bounds centre, so a 0-initialised max equals the -inf-padded one).
// Both kernels share the epilogue in common.cuh verbatim.
#include "common.cuh"

namespace {

__global__ void tail_projector_kernel(
    const int32_t* __restrict__ packed, int H, int W, int row0, int col0,
    int full_h, int full_w, const int16_t* __restrict__ proj_mapx,
    const int16_t* __restrict__ proj_mapy, long n_out,
    const int32_t* __restrict__ lut, float p03, float z_near, float z_far,
    int32_t* __restrict__ bgr_packed, uint8_t* __restrict__ bgr3,
    float* __restrict__ depth_out, float* __restrict__ disp_out) {
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int X = __ldg(proj_mapx + idx);
  const int Y = __ldg(proj_mapy + idx);
  int m = 0;
  if (X >= 0 && X < full_w && Y >= 0 && Y < full_h) {
    const int cy = Y - row0;
    const int cx = X - col0;
    const int r_lo = max(cy - 3, 0), r_hi = min(cy + 3, H - 1);
    const int c_lo = max(cx - 3, 0), c_hi = min(cx + 3, W - 1);
    for (int r = r_lo; r <= r_hi; ++r) {
      const int32_t* row = packed + static_cast<long>(r) * W;
      for (int c = c_lo; c <= c_hi; ++c) {
        m = max(m, static_cast<int>(static_cast<uint32_t>(__ldg(row + c)) &
                                    (xmaps::PACK - 1u)));
      }
    }
  }
  const float d = static_cast<float>(m);
  float depth;
  int32_t bgr;
  xmaps::depth_colorize(d, p03, z_near, z_far, lut, &depth, &bgr);
  xmaps::store_pixel(idx, d, depth, bgr, bgr_packed, bgr3, depth_out,
                     disp_out);
}

__global__ void colorize_camera_kernel(
    const int32_t* __restrict__ packed, long n, const int32_t* __restrict__ lut,
    float p03, float z_near, float z_far, int32_t* __restrict__ bgr_packed,
    uint8_t* __restrict__ bgr3, float* __restrict__ depth_out,
    float* __restrict__ disp_out) {
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float d = static_cast<float>(
      static_cast<uint32_t>(__ldg(packed + idx)) & (xmaps::PACK - 1u));
  float depth;
  int32_t bgr;
  xmaps::depth_colorize(d, p03, z_near, z_far, lut, &depth, &bgr);
  xmaps::store_pixel(idx, d, depth, bgr, bgr_packed, bgr3, depth_out,
                     disp_out);
}

constexpr int kThreads = 256;

inline unsigned grid_for(long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int tail_projector(
    const int32_t* packed, int H, int W, int row0, int col0, int full_h,
    int full_w, const int16_t* proj_mapx, const int16_t* proj_mapy, int Hp,
    int Wp, const int32_t* lut, float p03, float z_near, float z_far,
    int32_t* bgr_packed, uint8_t* bgr3, float* depth_out, float* disp_out,
    cudaStream_t stream) {
  const long n_out = static_cast<long>(Hp) * Wp;
  if (n_out > 0) {
    tail_projector_kernel<<<grid_for(n_out), kThreads, 0, stream>>>(
        packed, H, W, row0, col0, full_h, full_w, proj_mapx, proj_mapy, n_out,
        lut, p03, z_near, z_far, bgr_packed, bgr3, depth_out, disp_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int colorize_camera(
    const int32_t* packed, int n, const int32_t* lut, float p03, float z_near,
    float z_far, int32_t* bgr_packed, uint8_t* bgr3, float* depth_out,
    float* disp_out, cudaStream_t stream) {
  if (n > 0) {
    colorize_camera_kernel<<<grid_for(n), kThreads, 0, stream>>>(
        packed, n, lut, p03, z_near, z_far, bgr_packed, bgr3, depth_out,
        disp_out);
  }
  return static_cast<int>(cudaGetLastError());
}
