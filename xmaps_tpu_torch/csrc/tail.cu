// Kernels 2 and 3: the dense per-frame image tail.
//
// tail_projector replaces pallas_tail (xmaps_tpu/ops/pallas_tail.py:851,
// body _tail_core :453): packed crop map -> unpack -> 7x7 max dilate ->
// nearest remap through the i16 projector maps (0 out of bounds) -> depth ->
// u8 -> TURBO.  colorize_camera replaces pallas_colorize (:777, body
// _colorize_core :736): the camera view, unpack -> depth -> u8 -> TURBO.
//
// What bounds kernel 2 on the H100: memory traffic.  A frame must read the
// packed crop (4 B a crop pixel: 901 x 532 at the demonstrator, 1229 x 723
// at the ESL Table-2 rig) and write 4 B of packed BGR a projector pixel
// (720 x 1280, 1080 x 1920); the maps (4 B a projector pixel) are read once
// a call, whatever its frames.  A kernel that re-dilates a 7x7 window for
// every output pixel issues ~45 M scattered L1/L2 loads a frame and ran at
// a tenth of that bound, so there are two passes, as the TPU kernel
// dilated a band in VMEM before gathering from it (_tail_core :530-542):
// - tail_dilate: one 128-thread block per 122-column x 16-row strip of a
//   crop.  Thread t loads column t of the strip and its 3-px halo for the
//   22 rows (a warp reads 128 contiguous bytes a row; 1.05 x 1.38 over-
//   read), every load issued before the first use, takes the 7-tall max in
//   registers into a uint16 shared tile, and after one barrier the 7-wide
//   max, written as uint16 (disparities are < PACK = 8192): the dilated
//   crops (1.8 MB a frame at ESL) stay in L2 for the remap.  Disparities are
//   >= 0 and a window always holds its in-bounds centre, so the 0 padding
//   equals dilate_max's -inf padding: the result is bit-equal.
// - tail_remap_colorize: 4 projector pixels a thread (one 8-byte load of
//   each map, once for all the call's frames), 2-byte gathers from the
//   dilated crop, and in place of the depth/colour epilogue (two IEEE
//   divisions and a dependent LUT gather a pixel) one read of the engine's
//   colorize table (below), whose entry for a disparity equals the
//   epilogue bit for bit; 16-byte stores.  The frames are walked two at a
//   time, the two frames' gathers issued together.  The last thread takes
//   a ragged tail of Hp * Wp % 4 pixels with scalar accesses.
// The group entry (tail_projector_group) runs F frames' crops through the
// same two launches: the dilate takes the frame from blockIdx.z, the remap
// loops over the frames in each thread, writing frame f at f * out_stride
// pixels of each output.  The caller keeps out_stride a multiple of 8
// pixels, so every frame's 16-byte stores stay aligned.
// Why this design: experiments/kernel2_designs.py times it in turns against
// the previous one (a 32 x 32 shared-memory tile dilate with two barriers,
// then 8 px a thread through the divisions, every frame of a group
// re-reading both maps) and the other candidates, on an NVIDIA H100 80GB
// HBM3 at 700 W.
// The table halves the remap pass (ESL, group of 12: 107 -> 49 us); 4 px a
// thread beat 8 once depth is written (8 px: 74 against 54 us at the
// demonstrator); the maps read once a group beat the frame on a grid axis
// and splits of the frames over a small grid axis at ESL (49 against 63
// and 51-55 us); the strips beat the tile dilate in every cell (ESL group
// 51 -> 31.5 us), taller strips (32 rows) lose at one frame (fewer blocks),
// 8-row ones take 2-4% off one frame and lose a little at the ESL group,
// 64- and 256-wide ones tie, 32-wide ones lose; frame pairs take 1-4% off
// the group; streaming stores of the outputs gained nothing consistent.  A TMA tile
// load of the crop is not possible as such: its row pitch 4 W bytes must be
// a multiple of 16 and W is 723 at ESL (16-byte vector loads of the packed
// words fail on the same rows).
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

constexpr int kR = 3;  // dilate radius (7 x 7 window)
constexpr int kDilThreads = 128;  // crop columns a dilate block loads
constexpr int kDilOutW = kDilThreads - 2 * kR;  // ... and writes
constexpr int kDilRows = 16;  // crop rows a dilate block writes

// One block per 122-column x 16-row strip of crop blockIdx.z: thread t
// loads column blockIdx.x * 122 - 3 + t for the strip's rows and the 3-row
// halo (unpacked, 0 outside the crop; all 22 loads issued before the first
// use), takes the 7-tall max of each output row in registers into a uint16
// shared tile, and after one barrier the 122 output threads take the
// 7-wide max of their column from the tile.
__global__ void __launch_bounds__(kDilThreads)
tail_dilate_kernel(const int32_t* __restrict__ packed, int H, int W,
                   uint16_t* __restrict__ dil) {
  const long frame0 = static_cast<long>(blockIdx.z) * H * W;
  packed += frame0;
  dil += frame0;
  __shared__ uint16_t vmax[kDilRows][kDilThreads];
  const int t = threadIdx.x;
  const int c = blockIdx.x * kDilOutW - kR + t;  // the column t loads
  const int r0 = blockIdx.y * kDilRows;          // the strip's first row
  const bool col_in = c >= 0 && c < W;
  uint32_t v[kDilRows + 2 * kR];
#pragma unroll
  for (int i = 0; i < kDilRows + 2 * kR; ++i) {
    const int r = r0 - kR + i;
    v[i] = (col_in && r >= 0 && r < H)
               ? static_cast<uint32_t>(
                     __ldg(packed + static_cast<long>(r) * W + c)) &
                     (xmaps::PACK - 1u)
               : 0u;
  }
#pragma unroll
  for (int i = 0; i < kDilRows; ++i) {
    uint32_t m = v[i];
#pragma unroll
    for (int d = 1; d < 2 * kR + 1; ++d) m = max(m, v[i + d]);
    vmax[i][t] = static_cast<uint16_t>(m);
  }
  __syncthreads();
  const int oc = blockIdx.x * kDilOutW + t;
  if (t >= kDilOutW || oc >= W) return;
#pragma unroll
  for (int i = 0; i < kDilRows; ++i) {
    const int r = r0 + i;
    if (r >= H) break;
    uint32_t m = vmax[i][t];
#pragma unroll
    for (int d = 1; d < 2 * kR + 1; ++d) {
      m = max(m, static_cast<uint32_t>(vmax[i][t + d]));
    }
    dil[static_cast<long>(r) * W + oc] = static_cast<uint16_t>(m);
  }
}

// The flat index into the dilated crop that projector pixel (X, Y) samples,
// or -1 (disparity 0) outside the rect frame or the crop.
__device__ __forceinline__ int crop_index(int X, int Y, int H, int W, int row0,
                                          int col0, int full_h, int full_w) {
  const int cy = Y - row0, cx = X - col0;
  return (X >= 0 && X < full_w && Y >= 0 && Y < full_h && cy >= 0 && cy < H &&
          cx >= 0 && cx < W)
             ? cy * W + cx
             : -1;
}

constexpr int kPx = 4;  // projector pixels a remap thread: one int2 of each map
constexpr int kRemapThreads = 128;
static_assert(kPx == 4, "the remap pass's vector loads and stores hold 4 pixels");

// One frame's outputs of a remap thread's kPx pixels at pixel offset o,
// from their dilated disparities d: bgr_table[d] (and depth_table[d] where
// depth is written: colorize_table's epilogue of d, bit-equal to the
// divisions for every d < PACK), 16-byte stores of packed BGR, depth and
// disparity, three 4-byte words of 3-byte BGR.
__device__ __forceinline__ void colorize_store(
    const uint32_t* d, long o, const int32_t* __restrict__ bgr_table,
    const float* __restrict__ depth_table, int32_t* __restrict__ bgr_packed,
    uint8_t* __restrict__ bgr3, float* __restrict__ depth_out,
    float* __restrict__ disp_out) {
  int32_t bgr[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) bgr[k] = __ldg(bgr_table + d[k]);
  if (bgr_packed) {
    *reinterpret_cast<int4*>(bgr_packed + o) =
        make_int4(bgr[0], bgr[1], bgr[2], bgr[3]);
  }
  if (bgr3) {
    // 12 bytes at 3 * o: three 4-byte words
    uint32_t b3[3] = {0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 3 * kPx; ++b) {
      b3[b / 4] |= ((static_cast<uint32_t>(bgr[b / 3]) >> (8 * (b % 3))) & 255u)
                   << (8 * (b % 4));
    }
    uint32_t* w = reinterpret_cast<uint32_t*>(bgr3 + 3 * o);
    w[0] = b3[0];
    w[1] = b3[1];
    w[2] = b3[2];
  }
  if (depth_out) {
    *reinterpret_cast<float4*>(depth_out + o) =
        make_float4(__ldg(depth_table + d[0]), __ldg(depth_table + d[1]),
                    __ldg(depth_table + d[2]), __ldg(depth_table + d[3]));
  }
  if (disp_out) {
    *reinterpret_cast<float4*>(disp_out + o) =
        make_float4(static_cast<float>(d[0]), static_cast<float>(d[1]),
                    static_cast<float>(d[2]), static_cast<float>(d[3]));
  }
}

// The remap + colorize pass over F frames.  A thread loads the maps of its
// kPx projector pixels once (one 8-byte load of each map) and turns them
// into crop indices, then walks the frames two at a time: the 2 * kPx
// gathers of the dilated disparities from crops f and f + 1 issued
// together, then each frame's table reads and stores at f * out_stride +
// its pixels (colorize_store); an odd last frame alone.  The thread of a
// ragged tail of Hp * Wp % kPx pixels takes them with scalar accesses, for
// every frame.
__global__ void __launch_bounds__(kRemapThreads) tail_remap_colorize_kernel(
    const uint16_t* __restrict__ dil, int frames, int H, int W, int row0,
    int col0, int full_h, int full_w, const int16_t* __restrict__ proj_mapx,
    const int16_t* __restrict__ proj_mapy, long n_out, long out_stride,
    const int32_t* __restrict__ bgr_table,
    const float* __restrict__ depth_table, int32_t* __restrict__ bgr_packed,
    uint8_t* __restrict__ bgr3, float* __restrict__ depth_out,
    float* __restrict__ disp_out) {
  const long crop_px = static_cast<long>(H) * W;
  const long base =
      kPx * (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (base + kPx > n_out) {
    for (long k = base; k < n_out; ++k) {
      const int idx = crop_index(__ldg(proj_mapx + k), __ldg(proj_mapy + k), H,
                                 W, row0, col0, full_h, full_w);
      for (int f = 0; f < frames; ++f) {
        const uint32_t d = idx < 0 ? 0u : __ldg(dil + f * crop_px + idx);
        const float depth = depth_out ? __ldg(depth_table + d) : 0.0f;
        xmaps::store_pixel(f * out_stride + k, static_cast<float>(d), depth,
                           __ldg(bgr_table + d), bgr_packed, bgr3, depth_out,
                           disp_out);
      }
    }
    return;
  }
  const int2 mx = __ldg(reinterpret_cast<const int2*>(proj_mapx + base));
  const int2 my = __ldg(reinterpret_cast<const int2*>(proj_mapy + base));
  const int16_t* xs = reinterpret_cast<const int16_t*>(&mx);
  const int16_t* ys = reinterpret_cast<const int16_t*>(&my);
  int idx[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    idx[k] = crop_index(xs[k], ys[k], H, W, row0, col0, full_h, full_w);
  }
  int f = 0;
  for (; f + 1 < frames; f += 2) {
    const uint16_t* a = dil + f * crop_px;
    const uint16_t* b = a + crop_px;
    uint32_t da[kPx], db[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      da[k] = idx[k] < 0 ? 0u : __ldg(a + idx[k]);
      db[k] = idx[k] < 0 ? 0u : __ldg(b + idx[k]);
    }
    colorize_store(da, f * out_stride + base, bgr_table, depth_table,
                   bgr_packed, bgr3, depth_out, disp_out);
    colorize_store(db, (f + 1) * out_stride + base, bgr_table, depth_table,
                   bgr_packed, bgr3, depth_out, disp_out);
  }
  if (f < frames) {
    const uint16_t* a = dil + f * crop_px;
    uint32_t da[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) da[k] = idx[k] < 0 ? 0u : __ldg(a + idx[k]);
    colorize_store(da, f * out_stride + base, bgr_table, depth_table,
                   bgr_packed, bgr3, depth_out, disp_out);
  }
}

// The colorize table kernels 2 and 3 read: the epilogue of every disparity
// a packed map (d = packed & (PACK - 1)) or its dilation can hold, one
// thread a disparity, through the plain chain's depth_colorize and the
// plan's scalars, so a table entry equals the epilogue of its disparity bit
// for bit.  BGR and depth are two arrays: the display path, which writes no
// depth, reads only the 32 KB BGR table.
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
// (F, H, W) uint16 scratch, then the remap + colorize through the (PACK,)
// colorize table.  Returns the first launch error.  One frame
// (ops/cuda_tail.py tail_projector) is F = 1 with out_stride Hp * Wp.
extern "C" int tail_projector_group(
    const int32_t* packed, int frames, int H, int W, int row0, int col0,
    int full_h, int full_w, uint16_t* dil, const int16_t* proj_mapx,
    const int16_t* proj_mapy, int Hp, int Wp, long out_stride,
    const int32_t* bgr_table, const float* depth_table, int32_t* bgr_packed,
    uint8_t* bgr3, float* depth_out, float* disp_out, cudaStream_t stream) {
  if (frames < 1 || frames > 65535) return cudaErrorInvalidValue;
  if (H > 0 && W > 0) {
    const dim3 grid((W + kDilOutW - 1) / kDilOutW,
                    (H + kDilRows - 1) / kDilRows, frames);
    tail_dilate_kernel<<<grid, kDilThreads, 0, stream>>>(packed, H, W, dil);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long n_out = static_cast<long>(Hp) * Wp;
  if (n_out > 0) {
    const long groups = (n_out + kPx - 1) / kPx;
    tail_remap_colorize_kernel<<<
        static_cast<unsigned>((groups + kRemapThreads - 1) / kRemapThreads),
        kRemapThreads, 0, stream>>>(
        dil, frames, H, W, row0, col0, full_h, full_w, proj_mapx, proj_mapy,
        n_out, out_stride, bgr_table, depth_table, bgr_packed, bgr3, depth_out,
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
