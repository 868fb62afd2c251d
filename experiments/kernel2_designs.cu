// Designs of kernel 2 (tail_projector and its group entry), kept to time
// them against the one the port ships (xmaps_tpu_torch/csrc/tail.cu).
// experiments/kernel2_designs.py builds this file, checks every design
// bit-equal to the plain version and times them in turns.
//
//   design_previous   kernel 2 before the colorize table and the strips,
//                     verbatim (namespace previous, C entry renamed): a
//                     32 x 32 shared-memory tile dilate, then 8 projector px
//                     a thread with the epilogue's two IEEE divisions and
//                     the TURBO LUT gather, the frame on a grid axis (every
//                     frame reads both projector maps).
//   design_candidate  a dilate (0: the previous tile; 1-6: column strips of
//                     128 x 32, 128 x 16, 64 x 16, 128 x 8, 256 x 16 and
//                     32 x 16 threads x rows, below) and a remap through the
//                     colorize table, px (4 or 8) projector pixels a thread,
//                     `chunk` frames a block: chunk 1 puts the frame on a
//                     grid axis as the previous design did, chunk F reads
//                     the maps once a group, between them the frames are
//                     split over a small grid axis; `flags` (4 px only) bit 0: streaming stores
//                     of the outputs, bit 1: two frames' gathers issued
//                     together.  The port ships dilate 2 with the 4-px remap,
//                     chunk F, flags 2.
//
// The column-strip dilate: a block of T threads loads T neighbouring crop
// columns (T - 6 output columns and the 3-px halo on each side) for R + 6
// rows, one 4-byte load a row a thread (a warp reads 128 contiguous bytes),
// takes the 7-tall max of each output row in registers, writes it to a
// uint16 shared tile, and after one barrier takes the 7-wide max of each
// output pixel from shared memory: over-read (T / (T - 6)) x ((R + 6) / R),
// against the previous tile's 1.41x, and one barrier in place of two.
#include "common.cuh"

namespace previous {

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

}  // namespace previous

// F frames, two launches on one stream: the dilate into the caller's
// (F, H, W) uint16 scratch, then the remap + colorize.  Returns the first
// launch error.  One frame (ops/cuda_tail.py tail_projector) is F = 1 with
// out_stride Hp * Wp.
extern "C" int design_previous(
    const int32_t* packed, int frames, int H, int W, int row0, int col0,
    int full_h, int full_w, uint16_t* dil, const int16_t* proj_mapx,
    const int16_t* proj_mapy, int Hp, int Wp, long out_stride,
    const int32_t* lut, float p03, float z_near, float z_far,
    int32_t* bgr_packed, uint8_t* bgr3, float* depth_out, float* disp_out,
    cudaStream_t stream) {
  if (frames < 1 || frames > 65535) return cudaErrorInvalidValue;
  if (H > 0 && W > 0) {
    const dim3 block(previous::kDilTileW, previous::kDilThreadsY);
    const dim3 grid((W + previous::kDilTileW - 1) / previous::kDilTileW,
                    (H + previous::kDilTileH - 1) / previous::kDilTileH, frames);
    previous::tail_dilate_kernel<<<grid, block, 0, stream>>>(packed, H, W, dil);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long n_out = static_cast<long>(Hp) * Wp;
  if (n_out > 0) {
    const long groups = (n_out + previous::kPx - 1) / previous::kPx;
    const dim3 grid(
        static_cast<unsigned>((groups + previous::kRemapThreads - 1) / previous::kRemapThreads),
        frames);
    previous::tail_remap_colorize_kernel<<<grid, previous::kRemapThreads, 0, stream>>>(
        dil, H, W, row0, col0, full_h, full_w, proj_mapx, proj_mapy, n_out,
        out_stride, lut, p03, z_near, z_far, bgr_packed, bgr3, depth_out,
        disp_out);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int kR = 3;  // dilate radius (7 x 7 window)

template <int kThreads, int kRows>
__global__ void __launch_bounds__(kThreads)
dilate_strips_kernel(const int32_t* __restrict__ packed, int H, int W,
                     uint16_t* __restrict__ dil) {
  constexpr int kOutW = kThreads - 2 * kR;
  const long frame0 = static_cast<long>(blockIdx.z) * H * W;
  packed += frame0;
  dil += frame0;
  __shared__ uint16_t vmax[kRows][kThreads];
  const int t = threadIdx.x;
  const int c = blockIdx.x * kOutW - kR + t;  // the column this thread loads
  const int r0 = blockIdx.y * kRows;          // the strip's first output row
  const bool col_in = c >= 0 && c < W;
  uint32_t v[kRows + 2 * kR];
#pragma unroll
  for (int i = 0; i < kRows + 2 * kR; ++i) {
    const int r = r0 - kR + i;
    v[i] = (col_in && r >= 0 && r < H)
               ? static_cast<uint32_t>(
                     __ldg(packed + static_cast<long>(r) * W + c)) &
                     (xmaps::PACK - 1u)
               : 0u;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    uint32_t m = v[i];
#pragma unroll
    for (int d = 1; d < 2 * kR + 1; ++d) m = max(m, v[i + d]);
    vmax[i][t] = static_cast<uint16_t>(m);
  }
  __syncthreads();
  const int oc = blockIdx.x * kOutW + t;
  if (t >= kOutW || oc >= W) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    if (r >= H) break;
    uint32_t m = vmax[i][t];
#pragma unroll
    for (int d = 1; d < 2 * kR + 1; ++d) m = max(m, static_cast<uint32_t>(vmax[i][t + d]));
    dil[static_cast<long>(r) * W + oc] = static_cast<uint16_t>(m);
  }
}

template <int kThreads, int kRows>
void launch_strips(const int32_t* packed, int frames, int H, int W,
                   uint16_t* dil, cudaStream_t stream) {
  constexpr int kOutW = kThreads - 2 * kR;
  const dim3 grid((W + kOutW - 1) / kOutW, (H + kRows - 1) / kRows, frames);
  dilate_strips_kernel<kThreads, kRows><<<grid, kThreads, 0, stream>>>(
      packed, H, W, dil);
}

__device__ __forceinline__ int crop_index(int X, int Y, int H, int W, int row0,
                                          int col0, int full_h, int full_w) {
  const int cy = Y - row0, cx = X - col0;
  return (X >= 0 && X < full_w && Y >= 0 && Y < full_h && cy >= 0 && cy < H &&
          cx >= 0 && cx < W)
             ? cy * W + cx
             : -1;
}

template <int kPx>
__device__ __forceinline__ void crop_indices(const int16_t* xs,
                                             const int16_t* ys, int* idx, int H,
                                             int W, int row0, int col0,
                                             int full_h, int full_w) {
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    idx[k] = crop_index(xs[k], ys[k], H, W, row0, col0, full_h, full_w);
  }
}

constexpr int kRemapThreads = 128;

// A store that bypasses L2 residency where kStream (st.global.cs: the
// outputs are written once and never read here, the dilated crops the
// gathers read stay in L2).
template <bool kStream, class T>
__device__ __forceinline__ void put(T* p, T v) {
  if constexpr (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// One frame's outputs of a thread's kPx pixels at offset o, from their
// dilated disparities d.
template <int kPx, bool kStream>
__device__ __forceinline__ void emit(
    const uint32_t* d, long o, const int32_t* __restrict__ bgr_table,
    const float* __restrict__ depth_table, int32_t* __restrict__ bgr_packed,
    uint8_t* __restrict__ bgr3, float* __restrict__ depth_out,
    float* __restrict__ disp_out) {
  int32_t bgr[kPx];
  float depth[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    bgr[k] = __ldg(bgr_table + d[k]);
    depth[k] = depth_out ? __ldg(depth_table + d[k]) : 0.0f;
  }
  if (bgr_packed) {
#pragma unroll
    for (int q = 0; q < kPx / 4; ++q) {
      put<kStream>(reinterpret_cast<int4*>(bgr_packed + o) + q,
                   make_int4(bgr[4 * q], bgr[4 * q + 1], bgr[4 * q + 2],
                             bgr[4 * q + 3]));
    }
  }
  if (bgr3) {
    if constexpr (kPx == 8) {
      unsigned long long w[3] = {0ull, 0ull, 0ull};
#pragma unroll
      for (int b = 0; b < 3 * kPx; ++b) {
        const unsigned long long byte = (bgr[b / 3] >> (8 * (b % 3))) & 255;
        w[b / 8] |= byte << (8 * (b % 8));
      }
      unsigned long long* out = reinterpret_cast<unsigned long long*>(bgr3 + 3 * o);
      out[0] = w[0];
      out[1] = w[1];
      out[2] = w[2];
    } else {
      uint32_t w[3] = {0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 3 * kPx; ++b) {
        w[b / 4] |= ((static_cast<uint32_t>(bgr[b / 3]) >> (8 * (b % 3))) & 255u)
                    << (8 * (b % 4));
      }
      uint32_t* out = reinterpret_cast<uint32_t*>(bgr3 + 3 * o);
      put<kStream>(out, w[0]);
      put<kStream>(out + 1, w[1]);
      put<kStream>(out + 2, w[2]);
    }
  }
#pragma unroll
  for (int q = 0; q < kPx / 4; ++q) {
    if (depth_out) {
      put<kStream>(reinterpret_cast<float4*>(depth_out + o) + q,
                   make_float4(depth[4 * q], depth[4 * q + 1], depth[4 * q + 2],
                               depth[4 * q + 3]));
    }
    if (disp_out) {
      put<kStream>(reinterpret_cast<float4*>(disp_out + o) + q,
                   make_float4(static_cast<float>(d[4 * q]),
                               static_cast<float>(d[4 * q + 1]),
                               static_cast<float>(d[4 * q + 2]),
                               static_cast<float>(d[4 * q + 3])));
    }
  }
}

// kPx projector pixels a thread, frames [blockIdx.y * chunk, + chunk) of
// the group: the maps loaded once, then per frame the gathers, the table
// reads and the stores (16-byte stores; 3-byte BGR in 4-byte (kPx 4) or
// 8-byte (kPx 8) words); kStream: streaming stores; kPair: two frames'
// gathers issued together.
template <int kPx, bool kStream, bool kPair>
__global__ void __launch_bounds__(kRemapThreads) remap_table_kernel(
    const uint16_t* __restrict__ dil, int frames, int chunk, int H, int W,
    int row0, int col0, int full_h, int full_w,
    const int16_t* __restrict__ proj_mapx, const int16_t* __restrict__ proj_mapy,
    long n_out, long out_stride, const int32_t* __restrict__ bgr_table,
    const float* __restrict__ depth_table, int32_t* __restrict__ bgr_packed,
    uint8_t* __restrict__ bgr3, float* __restrict__ depth_out,
    float* __restrict__ disp_out) {
  const long crop_px = static_cast<long>(H) * W;
  const int f0 = blockIdx.y * chunk;
  const int f1 = min(frames, f0 + chunk);
  const long base =
      kPx * (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (base + kPx > n_out) {
    for (long k = base; k < n_out; ++k) {
      const int idx = crop_index(__ldg(proj_mapx + k), __ldg(proj_mapy + k), H,
                                 W, row0, col0, full_h, full_w);
      for (int f = f0; f < f1; ++f) {
        const uint32_t d = idx < 0 ? 0u : __ldg(dil + f * crop_px + idx);
        const float depth = depth_out ? __ldg(depth_table + d) : 0.0f;
        xmaps::store_pixel(f * out_stride + k, static_cast<float>(d), depth,
                           __ldg(bgr_table + d), bgr_packed, bgr3, depth_out,
                           disp_out);
      }
    }
    return;
  }
  int idx[kPx];
  if constexpr (kPx == 8) {
    const int4 mx = __ldg(reinterpret_cast<const int4*>(proj_mapx + base));
    const int4 my = __ldg(reinterpret_cast<const int4*>(proj_mapy + base));
    crop_indices<kPx>(reinterpret_cast<const int16_t*>(&mx),
                      reinterpret_cast<const int16_t*>(&my), idx, H, W, row0,
                      col0, full_h, full_w);
  } else {
    const int2 mx = __ldg(reinterpret_cast<const int2*>(proj_mapx + base));
    const int2 my = __ldg(reinterpret_cast<const int2*>(proj_mapy + base));
    crop_indices<kPx>(reinterpret_cast<const int16_t*>(&mx),
                      reinterpret_cast<const int16_t*>(&my), idx, H, W, row0,
                      col0, full_h, full_w);
  }
  int f = f0;
  if constexpr (kPair) {
    for (; f + 1 < f1; f += 2) {
      const uint16_t* a = dil + f * crop_px;
      const uint16_t* b = a + crop_px;
      uint32_t da[kPx], db[kPx];
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        da[k] = idx[k] < 0 ? 0u : __ldg(a + idx[k]);
        db[k] = idx[k] < 0 ? 0u : __ldg(b + idx[k]);
      }
      emit<kPx, kStream>(da, f * out_stride + base, bgr_table, depth_table,
                         bgr_packed, bgr3, depth_out, disp_out);
      emit<kPx, kStream>(db, (f + 1) * out_stride + base, bgr_table,
                         depth_table, bgr_packed, bgr3, depth_out, disp_out);
    }
  }
  for (; f < f1; ++f) {
    const uint16_t* crop = dil + f * crop_px;
    uint32_t d[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) d[k] = idx[k] < 0 ? 0u : __ldg(crop + idx[k]);
    emit<kPx, kStream>(d, f * out_stride + base, bgr_table, depth_table,
                       bgr_packed, bgr3, depth_out, disp_out);
  }
}

}  // namespace

// A candidate: dilate variant `dilate`, then the table remap at `px`
// pixels a thread and `chunk` frames a block, over F frames; the
// arguments after `chunk` are tail.cu's tail_projector_group's.
extern "C" int design_candidate(
    int dilate, int px, int chunk, int flags, const int32_t* packed, int frames, int H,
    int W, int row0, int col0, int full_h, int full_w, uint16_t* dil,
    const int16_t* proj_mapx, const int16_t* proj_mapy, int Hp, int Wp,
    long out_stride, const int32_t* bgr_table, const float* depth_table,
    int32_t* bgr_packed, uint8_t* bgr3, float* depth_out, float* disp_out,
    cudaStream_t stream) {
  if (frames < 1 || frames > 65535 || chunk < 1 || (px != 4 && px != 8) ||
      (px == 8 && flags != 0) || flags < 0 || flags > 3) {
    return cudaErrorInvalidValue;
  }
  if (H > 0 && W > 0) {
    if (dilate == 0) {
      const dim3 block(previous::kDilTileW, previous::kDilThreadsY);
      const dim3 grid((W + previous::kDilTileW - 1) / previous::kDilTileW,
                      (H + previous::kDilTileH - 1) / previous::kDilTileH, frames);
      previous::tail_dilate_kernel<<<grid, block, 0, stream>>>(packed, H, W, dil);
    } else if (dilate == 1) {
      launch_strips<128, 32>(packed, frames, H, W, dil, stream);
    } else if (dilate == 2) {
      launch_strips<128, 16>(packed, frames, H, W, dil, stream);
    } else if (dilate == 3) {
      launch_strips<64, 16>(packed, frames, H, W, dil, stream);
    } else if (dilate == 4) {
      launch_strips<128, 8>(packed, frames, H, W, dil, stream);
    } else if (dilate == 5) {
      launch_strips<256, 16>(packed, frames, H, W, dil, stream);
    } else if (dilate == 6) {
      launch_strips<32, 16>(packed, frames, H, W, dil, stream);
    } else {
      return cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long n_out = static_cast<long>(Hp) * Wp;
  if (n_out > 0) {
    const long threads = (n_out + px - 1) / px;
    const dim3 grid(
        static_cast<unsigned>((threads + kRemapThreads - 1) / kRemapThreads),
        (frames + chunk - 1) / chunk);
#define XMAPS_REMAP(PX, STREAM, PAIR)                                      \
  remap_table_kernel<PX, STREAM, PAIR><<<grid, kRemapThreads, 0, stream>>>( \
      dil, frames, chunk, H, W, row0, col0, full_h, full_w, proj_mapx,      \
      proj_mapy, n_out, out_stride, bgr_table, depth_table, bgr_packed, bgr3, \
      depth_out, disp_out)
    if (px == 8) {
      XMAPS_REMAP(8, false, false);
    } else if (flags == 0) {
      XMAPS_REMAP(4, false, false);
    } else if (flags == 1) {
      XMAPS_REMAP(4, true, false);
    } else if (flags == 2) {
      XMAPS_REMAP(4, false, true);
    } else {
      XMAPS_REMAP(4, true, true);
    }
#undef XMAPS_REMAP
  }
  return static_cast<int>(cudaGetLastError());
}
