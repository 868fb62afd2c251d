// Other designs of kernel 3 (colorize_camera), kept to time them against
// the one the port ships (xmaps_tpu_torch/csrc/tail.cu: 4 pixels a thread
// through the per-engine colorize table).  experiments/kernel3_designs.py
// builds this file, checks every design bit-equal to the plain version and
// times them in turns.
//
//   design_one_px  one pixel a thread, 256-thread blocks, the epilogue's
//                  two IEEE divisions (xmaps::depth_colorize): kernel 3
//                  before the table.
//   design_eight_px
//                  eight pixels a thread (two 16-byte loads of the packed
//                  map, 16-byte stores; 3-byte BGR as three 8-byte words),
//                  128-thread blocks, with the divisions (table == 0) or
//                  through the colorize table (table == 1).
#include "common.cuh"

namespace {

constexpr int kOneThreads = 256;
constexpr int kEightThreads = 128;

__global__ void one_px_kernel(
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

// The depth and BGR of one packed word: the divisions or the table.
template <bool kTable>
__device__ __forceinline__ void epilogue(
    uint32_t d, const int32_t* __restrict__ lut, float p03, float z_near,
    float z_far, const int32_t* __restrict__ bgr_table,
    const float* __restrict__ depth_table, bool want_depth, float* depth,
    int32_t* bgr) {
  if (kTable) {
    *bgr = __ldg(bgr_table + d);
    *depth = want_depth ? __ldg(depth_table + d) : 0.0f;
  } else {
    xmaps::depth_colorize(static_cast<float>(d), p03, z_near, z_far, lut,
                          depth, bgr);
  }
}

template <bool kTable>
__global__ void __launch_bounds__(kEightThreads) eight_px_kernel(
    const int32_t* __restrict__ packed, long n, const int32_t* __restrict__ lut,
    float p03, float z_near, float z_far, const int32_t* __restrict__ bgr_table,
    const float* __restrict__ depth_table, int32_t* __restrict__ bgr_packed,
    uint8_t* __restrict__ bgr3, float* __restrict__ depth_out,
    float* __restrict__ disp_out) {
  const long base =
      8 * (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x);
  const bool want_depth = depth_out != nullptr;
  if (base + 8 > n) {
    for (long k = base; k < n; ++k) {
      const uint32_t d =
          static_cast<uint32_t>(__ldg(packed + k)) & (xmaps::PACK - 1u);
      float depth;
      int32_t bgr;
      epilogue<kTable>(d, lut, p03, z_near, z_far, bgr_table, depth_table,
                       want_depth, &depth, &bgr);
      xmaps::store_pixel(k, static_cast<float>(d), depth, bgr, bgr_packed,
                         bgr3, depth_out, disp_out);
    }
    return;
  }
  const int4 w0 = __ldg(reinterpret_cast<const int4*>(packed + base));
  const int4 w1 = __ldg(reinterpret_cast<const int4*>(packed + base + 4));
  const int32_t words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  float disp[8], depth[8];
  int32_t bgr[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t d = static_cast<uint32_t>(words[k]) & (xmaps::PACK - 1u);
    disp[k] = static_cast<float>(d);
    epilogue<kTable>(d, lut, p03, z_near, z_far, bgr_table, depth_table,
                     want_depth, &depth[k], &bgr[k]);
  }
  if (bgr_packed) {
    int4* o = reinterpret_cast<int4*>(bgr_packed + base);
    o[0] = make_int4(bgr[0], bgr[1], bgr[2], bgr[3]);
    o[1] = make_int4(bgr[4], bgr[5], bgr[6], bgr[7]);
  }
  if (bgr3) {
    // 24 bytes at 3 * base: three 8-byte words
    uint32_t b3[6] = {0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 24; ++b) {
      b3[b / 4] |= ((static_cast<uint32_t>(bgr[b / 3]) >> (8 * (b % 3))) & 255u)
                   << (8 * (b % 4));
    }
    uint2* o = reinterpret_cast<uint2*>(bgr3 + 3 * base);
    o[0] = make_uint2(b3[0], b3[1]);
    o[1] = make_uint2(b3[2], b3[3]);
    o[2] = make_uint2(b3[4], b3[5]);
  }
  if (depth_out) {
    float4* o = reinterpret_cast<float4*>(depth_out + base);
    o[0] = make_float4(depth[0], depth[1], depth[2], depth[3]);
    o[1] = make_float4(depth[4], depth[5], depth[6], depth[7]);
  }
  if (disp_out) {
    float4* o = reinterpret_cast<float4*>(disp_out + base);
    o[0] = make_float4(disp[0], disp[1], disp[2], disp[3]);
    o[1] = make_float4(disp[4], disp[5], disp[6], disp[7]);
  }
}

}  // namespace

extern "C" int design_one_px(const int32_t* packed, int n, const int32_t* lut,
                             float p03, float z_near, float z_far,
                             int32_t* bgr_packed, uint8_t* bgr3,
                             float* depth_out, float* disp_out,
                             cudaStream_t stream) {
  if (n > 0) {
    one_px_kernel<<<(n + kOneThreads - 1) / kOneThreads, kOneThreads, 0,
                    stream>>>(packed, n, lut, p03, z_near, z_far, bgr_packed,
                              bgr3, depth_out, disp_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int design_eight_px(int table, const int32_t* packed, int n,
                               const int32_t* lut, float p03, float z_near,
                               float z_far, const int32_t* bgr_table,
                               const float* depth_table, int32_t* bgr_packed,
                               uint8_t* bgr3, float* depth_out,
                               float* disp_out, cudaStream_t stream) {
  if (n > 0) {
    const long groups = (static_cast<long>(n) + 7) / 8;
    const unsigned blocks =
        static_cast<unsigned>((groups + kEightThreads - 1) / kEightThreads);
    if (table) {
      eight_px_kernel<true><<<blocks, kEightThreads, 0, stream>>>(
          packed, n, lut, p03, z_near, z_far, bgr_table, depth_table,
          bgr_packed, bgr3, depth_out, disp_out);
    } else {
      eight_px_kernel<false><<<blocks, kEightThreads, 0, stream>>>(
          packed, n, lut, p03, z_near, z_far, bgr_table, depth_table,
          bgr_packed, bgr3, depth_out, disp_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
