// Shared constants and the per-pixel depth/colorize epilogue of the tail
// kernels (tail.cu: colorize_table writes it for each of the PACK
// disparities once per engine; kernels 2 and 3 read that table).  The
// arithmetic is written with explicit round-to-nearest intrinsics so that
// no contraction or fast-math rewrite can change a u8 bin: the results
// equal the plain PyTorch chain (ops/image_tail.py) and the JAX package's
// XLA chain bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace xmaps {

constexpr int X_OFFSET = 4242;  // config.X_OFFSET
constexpr unsigned PACK = 8192u;  // ops/scatter.py PACK (a power of two)

// depth = max(p03 / d, 1e-9) with 0 kept as 0; u8 = C truncation of the
// [z_near, z_far] normalization clipped to [0, 255]; BGR from the packed
// TURBO LUT (entry 0 white).  Mirrors image_tail.disparity_to_depth,
// clip_normalize_u8 and colorize_turbo_packed.
__device__ __forceinline__ void depth_colorize(
    float d, float p03, float z_near, float z_far,
    const int32_t* __restrict__ lut, float* depth_out, int32_t* bgr_out) {
  const float safe = (d == 0.0f) ? 1.0f : d;
  float depth = fmaxf(__fdiv_rn(p03, safe), 1e-9f);
  depth = (d == 0.0f) ? 0.0f : depth;
  float v = fminf(fmaxf(depth, z_near), z_far);
  v = __fmul_rn(__fdiv_rn(__fsub_rn(v, z_near), __fsub_rn(z_far, z_near)),
                255.0f);
  v = (depth == 0.0f) ? 0.0f : v;
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  *depth_out = depth;
  *bgr_out = __ldg(lut + static_cast<int>(v));
}

// Store one pixel's outputs; null pointers skip an output.
__device__ __forceinline__ void store_pixel(
    long idx, float disp, float depth, int32_t bgr,
    int32_t* bgr_packed, uint8_t* bgr3, float* depth_out, float* disp_out) {
  if (bgr_packed) bgr_packed[idx] = bgr;
  if (bgr3) {
    bgr3[3 * idx + 0] = static_cast<uint8_t>(bgr & 255);
    bgr3[3 * idx + 1] = static_cast<uint8_t>((bgr >> 8) & 255);
    bgr3[3 * idx + 2] = static_cast<uint8_t>((bgr >> 16) & 255);
  }
  if (depth_out) depth_out[idx] = depth;
  if (disp_out) disp_out[idx] = disp;
}

}  // namespace xmaps
