// Kernels 2 and 3: the dense per-frame image tail.
//
// tail_projector replaces pallas_tail (xmaps_tpu/ops/pallas_tail.py:851,
// body _tail_core :453): packed crop map -> unpack -> 7x7 max dilate ->
// nearest remap through the i16 projector maps (0 out of bounds) -> depth ->
// u8 -> TURBO.  colorize_camera replaces pallas_colorize (:777, body
// _colorize_core :736): the camera view, unpack -> depth -> u8 -> TURBO.
//
// What bounds them on the H100: memory traffic.  The projector tail must
// read the packed crop (4 B a crop pixel: 901 x 532 at the demonstrator)
// and 4 B of maps a projector pixel, and write 4 B of packed BGR (or 3 B
// of BGR plus 8 B of f32 depth/disp) a projector pixel: ~9 MB at the
// demonstrator's 0.92 Mpx, under 3 us at 3.35 TB/s.  A kernel that
// re-dilates a 7x7 window for every output pixel issues ~45 M scattered
// L1/L2 loads a frame (each crop pixel is sampled ~1.9 times) and runs at a
// tenth of that bound.
//
// What the design does about it: two passes, as the TPU kernel dilated a
// band in VMEM before gathering from it (_tail_core :530-542).
// - tail_dilate: one block per 32 x 32 tile of the crop.  The tile and its
//   3-px halo are loaded into shared memory (unpacked while loading, 0
//   outside the crop), a 7-wide horizontal max goes into a second shared
//   array, then a 7-tall vertical max is written as uint16 (disparities
//   are < PACK = 8192): ~14 compares a crop pixel, and the 1 MB dilated
//   crop stays in L2.  Disparities are >= 0 and a window always holds its
//   in-bounds centre, so the 0 padding equals dilate_max's -inf padding:
//   the result is bit-equal.
// - tail_remap_colorize: 8 consecutive projector pixels a thread, one
//   16-byte load of each map, 8 gathers from the u16 dilated crop, the
//   shared epilogue of common.cuh, and 16-byte stores of packed BGR and
//   f32 depth/disp (8-byte stores of 3-byte BGR); the last thread takes a
//   ragged tail of Hp * Wp % 8 pixels with scalar accesses.  Blocks of 128
//   threads: the whole grid is one wave, and smaller blocks spread it more
//   evenly over the SMs.  Beside its bytes, this pass pays for the
//   epilogue's two IEEE divisions a pixel.
// Both halo-tile and block sizes were chosen by timing variants on the
// H100 at the demonstrator's shapes.
// The group entry (tail_projector_group) runs F frames' crops through the
// same two launches: the dilate takes the frame from blockIdx.z (crop f of
// contiguous (F, H, W) maps into scratch f), the remap from blockIdx.y,
// writing frame f at f * out_stride pixels of each output.  The caller
// keeps out_stride a multiple of 8 pixels, so every frame's 16-byte (and
// 3-byte BGR's 8-byte) stores stay aligned; each frame's ragged tail of
// Hp * Wp % 8 pixels takes the scalar path.
//
// colorize_camera moves 8 B a camera pixel (2.5 MB at 640 x 480, 0.74 us
// at 3.35 TB/s).  One pixel a thread in 256-thread blocks left one
// dependent chain a thread (load, two IEEE divisions, LUT gather, store)
// over 1.14 waves.  Its result depends on the disparity packed & (PACK - 1)
// alone, so colorize_table writes the epilogue of all 8192 disparities once
// per engine (32 KB of BGR, 32 KB of depth), and the pass reads 4 pixels a
// thread with one 16-byte load, looks each up in the table (the few
// distinct disparities of a frame stay in L1) and stores 16 bytes at a time:
// 128-thread blocks, one wave at 640 x 480.  Four pixels a thread, with
// neighbouring threads on neighbouring 16-byte runs, timed faster on the
// H100 than eight (two runs a thread, which split each warp access in two)
// in every output variant (experiments/kernel3_designs.py times the
// designs in turns).  The table stays in global memory: filling 32 KB
// of shared memory in each block would read several times the image from
// L2.
#include "common.cuh"

namespace {

constexpr int kDilTileW = 32;  // crop columns a dilate block writes
constexpr int kDilTileH = 32;  // crop rows a dilate block writes
constexpr int kDilThreadsY = 8;  // 32 x 8 threads, 4 output rows each
constexpr int kDilThreads = kDilTileW * kDilThreadsY;
constexpr int kR = 3;  // dilate radius (7 x 7 window)
constexpr int kHaloW = kDilTileW + 2 * kR;
constexpr int kHaloH = kDilTileH + 2 * kR;
constexpr int kHaloLoads = (kHaloH * kHaloW + kDilThreads - 1) / kDilThreads;

__global__ void __launch_bounds__(kDilThreads)
tail_dilate_kernel(const int32_t* __restrict__ packed, int H, int W,
                   uint16_t* __restrict__ dil) {
  const long frame0 = static_cast<long>(blockIdx.z) * H * W;
  packed += frame0;
  dil += frame0;
  __shared__ int tile[kHaloH][kHaloW];
  __shared__ int hmax[kHaloH][kDilTileW];
  const int tx = threadIdx.x;  // column in the tile
  const int ty = threadIdx.y;
  const int tid = ty * kDilTileW + tx;
  const int c0 = blockIdx.x * kDilTileW - kR;
  const int r0 = blockIdx.y * kDilTileH - kR;
  // every load of the halo tile is issued before the first shared store
  int v[kHaloLoads];
#pragma unroll
  for (int i = 0; i < kHaloLoads; ++i) {
    const int k = i * kDilThreads + tid;
    const int r = k / kHaloW, c = k - r * kHaloW;
    const int gr = r0 + r, gc = c0 + c;
    v[i] = 0;
    if (k < kHaloH * kHaloW && gr >= 0 && gr < H && gc >= 0 && gc < W) {
      v[i] = static_cast<int>(
          static_cast<uint32_t>(__ldg(packed + static_cast<long>(gr) * W + gc)) &
          (xmaps::PACK - 1u));
    }
  }
#pragma unroll
  for (int i = 0; i < kHaloLoads; ++i) {
    const int k = i * kDilThreads + tid;
    if (k < kHaloH * kHaloW) (&tile[0][0])[k] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < kHaloH; r += kDilThreadsY) {
    int m = tile[r][tx];
#pragma unroll
    for (int d = 1; d < 2 * kR + 1; ++d) m = max(m, tile[r][tx + d]);
    hmax[r][tx] = m;
  }
  __syncthreads();
  const int gc = blockIdx.x * kDilTileW + tx;
  if (gc >= W) return;
#pragma unroll
  for (int r = ty; r < kDilTileH; r += kDilThreadsY) {
    const int gr = blockIdx.y * kDilTileH + r;
    if (gr >= H) break;
    int m = hmax[r][tx];
#pragma unroll
    for (int d = 1; d < 2 * kR + 1; ++d) m = max(m, hmax[r + d][tx]);
    dil[static_cast<long>(gr) * W + gc] = static_cast<uint16_t>(m);
  }
}

// The dilated disparity a projector pixel samples: 0 outside the rect
// frame or the crop.
__device__ __forceinline__ float sample_dilated(
    int X, int Y, const uint16_t* __restrict__ dil, int H, int W, int row0,
    int col0, int full_h, int full_w) {
  const int cy = Y - row0, cx = X - col0;
  if (X >= 0 && X < full_w && Y >= 0 && Y < full_h && cy >= 0 && cy < H &&
      cx >= 0 && cx < W) {
    return static_cast<float>(__ldg(dil + static_cast<long>(cy) * W + cx));
  }
  return 0.0f;
}

constexpr int kPx = 8;  // projector pixels a remap thread
constexpr int kRemapThreads = 128;

__global__ void tail_remap_colorize_kernel(
    const uint16_t* __restrict__ dil, int H, int W, int row0, int col0,
    int full_h, int full_w, const int16_t* __restrict__ proj_mapx,
    const int16_t* __restrict__ proj_mapy, long n_out, long out_stride,
    const int32_t* __restrict__ lut, float p03, float z_near, float z_far,
    int32_t* __restrict__ bgr_packed, uint8_t* __restrict__ bgr3,
    float* __restrict__ depth_out, float* __restrict__ disp_out) {
  // frame blockIdx.y: its dilated crop, and its pixels of each output
  const long f = blockIdx.y;
  dil += f * H * W;
  if (bgr_packed) bgr_packed += f * out_stride;
  if (bgr3) bgr3 += 3 * f * out_stride;
  if (depth_out) depth_out += f * out_stride;
  if (disp_out) disp_out += f * out_stride;
  const long base =
      kPx * (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (base + kPx > n_out) {
    // ragged tail: scalar accesses
    for (long k = base; k < n_out; ++k) {
      const float d = sample_dilated(__ldg(proj_mapx + k), __ldg(proj_mapy + k),
                                     dil, H, W, row0, col0, full_h, full_w);
      float depth;
      int32_t bgr;
      xmaps::depth_colorize(d, p03, z_near, z_far, lut, &depth, &bgr);
      xmaps::store_pixel(k, d, depth, bgr, bgr_packed, bgr3, depth_out,
                         disp_out);
    }
    return;
  }
  const int4 mx = __ldg(reinterpret_cast<const int4*>(proj_mapx + base));
  const int4 my = __ldg(reinterpret_cast<const int4*>(proj_mapy + base));
  const int16_t* xs = reinterpret_cast<const int16_t*>(&mx);
  const int16_t* ys = reinterpret_cast<const int16_t*>(&my);
  float disp[kPx], depth[kPx];
  int32_t bgr[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    disp[k] = sample_dilated(xs[k], ys[k], dil, H, W, row0, col0, full_h,
                             full_w);
  }
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    xmaps::depth_colorize(disp[k], p03, z_near, z_far, lut, &depth[k],
                          &bgr[k]);
  }
  if (bgr_packed) {
    int4* o = reinterpret_cast<int4*>(bgr_packed + base);
    o[0] = make_int4(bgr[0], bgr[1], bgr[2], bgr[3]);
    o[1] = make_int4(bgr[4], bgr[5], bgr[6], bgr[7]);
  }
  if (bgr3) {
    // 24 bytes at 24 * (base / 8): three 8-byte words
    unsigned long long w[3] = {0ull, 0ull, 0ull};
#pragma unroll
    for (int b = 0; b < 3 * kPx; ++b) {
      const unsigned long long byte = (bgr[b / 3] >> (8 * (b % 3))) & 255;
      w[b / 8] |= byte << (8 * (b % 8));
    }
    unsigned long long* o =
        reinterpret_cast<unsigned long long*>(bgr3 + 3 * base);
    o[0] = w[0];
    o[1] = w[1];
    o[2] = w[2];
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

// Kernel 3's table: the epilogue of every disparity a packed map can hold
// (d = packed & (PACK - 1)), one thread a disparity, through the same
// depth_colorize and scalars as kernel 2, so a table entry equals the
// epilogue of its disparity bit for bit.  BGR and depth are two arrays: the
// display path, which writes no depth, reads only the 32 KB BGR table.
__global__ void colorize_table_kernel(const int32_t* __restrict__ lut,
                                      float p03, float z_near, float z_far,
                                      int32_t* __restrict__ bgr_table,
                                      float* __restrict__ depth_table) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= static_cast<int>(xmaps::PACK)) return;
  float depth;
  int32_t bgr;
  xmaps::depth_colorize(static_cast<float>(d), p03, z_near, z_far, lut, &depth,
                        &bgr);
  bgr_table[d] = bgr;
  depth_table[d] = depth;
}

constexpr int kCamPx = 4;  // camera pixels a colorize thread: one int4
constexpr int kCamThreads = 128;

// Kernel 3: kCamPx consecutive pixels a thread, neighbouring threads on
// neighbouring 16-byte runs, so that every load and store of a warp covers
// one contiguous run: one int4 of the packed map in, one table read a
// pixel (two with depth) in place of the epilogue, 16-byte stores of packed
// BGR, depth and disparity, three 4-byte words of 3-byte BGR.  The last
// thread takes a ragged tail of n % kCamPx pixels with scalar accesses.
__global__ void __launch_bounds__(kCamThreads) colorize_camera_kernel(
    const int32_t* __restrict__ packed, long n,
    const int32_t* __restrict__ bgr_table,
    const float* __restrict__ depth_table, int32_t* __restrict__ bgr_packed,
    uint8_t* __restrict__ bgr3, float* __restrict__ depth_out,
    float* __restrict__ disp_out) {
  const long base =
      kCamPx * (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (base + kCamPx > n) {
    for (long k = base; k < n; ++k) {
      const uint32_t d =
          static_cast<uint32_t>(__ldg(packed + k)) & (xmaps::PACK - 1u);
      const float depth = depth_out ? __ldg(depth_table + d) : 0.0f;
      xmaps::store_pixel(k, static_cast<float>(d), depth,
                         __ldg(bgr_table + d), bgr_packed, bgr3, depth_out,
                         disp_out);
    }
    return;
  }
  const int4 w = __ldg(reinterpret_cast<const int4*>(packed + base));
  const int32_t words[kCamPx] = {w.x, w.y, w.z, w.w};
  float disp[kCamPx], depth[kCamPx];
  int32_t bgr[kCamPx];
#pragma unroll
  for (int k = 0; k < kCamPx; ++k) {
    const uint32_t d = static_cast<uint32_t>(words[k]) & (xmaps::PACK - 1u);
    disp[k] = static_cast<float>(d);
    bgr[k] = __ldg(bgr_table + d);
    depth[k] = depth_out ? __ldg(depth_table + d) : 0.0f;
  }
  if (bgr_packed) {
    *reinterpret_cast<int4*>(bgr_packed + base) =
        make_int4(bgr[0], bgr[1], bgr[2], bgr[3]);
  }
  if (bgr3) {
    // 12 bytes at 3 * base: three 4-byte words
    uint32_t b3[3] = {0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 3 * kCamPx; ++b) {
      b3[b / 4] |= ((static_cast<uint32_t>(bgr[b / 3]) >> (8 * (b % 3))) & 255u)
                   << (8 * (b % 4));
    }
    uint32_t* o = reinterpret_cast<uint32_t*>(bgr3 + 3 * base);
    o[0] = b3[0];
    o[1] = b3[1];
    o[2] = b3[2];
  }
  if (depth_out) {
    *reinterpret_cast<float4*>(depth_out + base) =
        make_float4(depth[0], depth[1], depth[2], depth[3]);
  }
  if (disp_out) {
    *reinterpret_cast<float4*>(disp_out + base) =
        make_float4(disp[0], disp[1], disp[2], disp[3]);
  }
}

}  // namespace

// F frames, two launches on one stream: the dilate into the caller's
// (F, H, W) uint16 scratch, then the remap + colorize.  Returns the first
// launch error.  One frame (ops/cuda_tail.py tail_projector) is F = 1 with
// out_stride Hp * Wp.
extern "C" int tail_projector_group(
    const int32_t* packed, int frames, int H, int W, int row0, int col0,
    int full_h, int full_w, uint16_t* dil, const int16_t* proj_mapx,
    const int16_t* proj_mapy, int Hp, int Wp, long out_stride,
    const int32_t* lut, float p03, float z_near, float z_far,
    int32_t* bgr_packed, uint8_t* bgr3, float* depth_out, float* disp_out,
    cudaStream_t stream) {
  if (frames < 1 || frames > 65535) return cudaErrorInvalidValue;
  if (H > 0 && W > 0) {
    const dim3 block(kDilTileW, kDilThreadsY);
    const dim3 grid((W + kDilTileW - 1) / kDilTileW,
                    (H + kDilTileH - 1) / kDilTileH, frames);
    tail_dilate_kernel<<<grid, block, 0, stream>>>(packed, H, W, dil);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long n_out = static_cast<long>(Hp) * Wp;
  if (n_out > 0) {
    const long groups = (n_out + kPx - 1) / kPx;
    const dim3 grid(
        static_cast<unsigned>((groups + kRemapThreads - 1) / kRemapThreads),
        frames);
    tail_remap_colorize_kernel<<<grid, kRemapThreads, 0, stream>>>(
        dil, H, W, row0, col0, full_h, full_w, proj_mapx, proj_mapy, n_out,
        out_stride, lut, p03, z_near, z_far, bgr_packed, bgr3, depth_out,
        disp_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int colorize_table(const int32_t* lut, float p03, float z_near,
                              float z_far, int32_t* bgr_table,
                              float* depth_table, cudaStream_t stream) {
  constexpr int threads = 256;
  colorize_table_kernel<<<xmaps::PACK / threads, threads, 0, stream>>>(
      lut, p03, z_near, z_far, bgr_table, depth_table);
  return static_cast<int>(cudaGetLastError());
}

// The packed map and the outputs must be 16-byte aligned (the wrapper
// checks the map; it allocates the outputs).  Kernel 3 is a pure pass over
// pixels through the table, so its group entry (ops/cuda_tail.py
// colorize_camera_group) is this launch with n = F * H * W over contiguous
// (F, H, W) maps and outputs: a thread's 4 pixels may straddle two frames,
// which changes nothing, and only the last n % 4 pixels are ragged.
extern "C" int colorize_camera(
    const int32_t* packed, int n, const int32_t* bgr_table,
    const float* depth_table, int32_t* bgr_packed, uint8_t* bgr3,
    float* depth_out, float* disp_out, cudaStream_t stream) {
  if (n > 0) {
    const long groups = (static_cast<long>(n) + kCamPx - 1) / kCamPx;
    colorize_camera_kernel<<<
        static_cast<unsigned>((groups + kCamThreads - 1) / kCamThreads),
        kCamThreads, 0, stream>>>(packed, n, bgr_table, depth_table,
                                  bgr_packed, bgr3, depth_out, disp_out);
  }
  return static_cast<int>(cudaGetLastError());
}
