// Kernel 1: event_disparity_scatter -- per-event rectify + X-map gather +
// disparity + last-write-wins scatter of one frame, in one pass.
//
// Replaces the TPU kernels rectify_and_lookup (xmaps_tpu/ops/pallas_events.py:508)
// and rectify_and_lookup_hbm (:422) together with the XLA disparity/inlier
// math (xmaps_tpu/ops/disparity.py:299-309) and the packed scatter
// (xmaps_tpu/ops/scatter.py, method "max"/"sorted").
//
// What bounds it on the H100: dependent random reads.  Each event does two
// table gathers (4 B from the packed camera LUT, 2 B from the i16 X-map) and
// one atomicMax into the packed disparity map; at ~28k events a frame that
// is ~170 KB of event reads and ~56k scattered 32 B sectors -- latency, not
// bandwidth.  Both tables fit in the 50 MB L2 at both geometries (camera LUT
// 1.2 MB; X-map 1.9 MB at the demonstrator, 12.4 MB at the ESL rig).
//
// What the design does about it: one thread per event lane, tables read
// through the read-only path straight from global memory / L2.  The TPU
// kernel's y-sort and VMEM row banding existed because a TPU gather is a
// serial scalar loop; here the hardware gathers, so there is no sort and no
// band plan, and any capacity works (no 1024-lane blocking).  Determinism
// comes from the packed key (prio + 1) * PACK + disp: atomicMax keeps the
// highest priority per pixel, which is NumPy's last-write-wins regardless
// of the order in which threads run.  The priority is the lane index, or
// with a dedup frame filter (ops/filters.py) the lane's dense raster rank,
// read from an optional per-lane int32 array (< capacity).  The key is unsigned 32-bit, as in the
// JAX package, so capacities up to 524286 lanes fit (the offline eval's
// whole-image batch is 307200); the map is handed over as int32 words.
// The inlier count is reduced per warp (ballot + popc) before one
// atomicAdd.
#include "common.cuh"

namespace {

__global__ void event_disparity_scatter_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ y,
    const int32_t* __restrict__ t_bin, const bool* __restrict__ valid,
    const int32_t* __restrict__ prio, int n,
    const int32_t* __restrict__ cam_lut, int cam_h, int cam_w,
    const int16_t* __restrict__ x_map, int xmap_h, int xmap_w,
    int camera_view, int oy, int ox, int out_h, int out_w,
    uint32_t* __restrict__ packed_map, int32_t* __restrict__ inlier_count,
    int32_t* __restrict__ xr_out, int32_t* __restrict__ yr_out,
    int32_t* __restrict__ xproj_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool inlier = false;
  if (i < n) {
    const int xi = x[i];
    const int yi = y[i];
    // 1-2. clip the raw coordinates, gather from the packed camera LUT
    //      (mapy << 16 | mapx & 0xffff) and sign-extend both i16 halves
    const int yc = min(max(yi, 0), cam_h - 1);
    const int xc = min(max(xi, 0), cam_w - 1);
    const int32_t pk = __ldg(cam_lut + yc * cam_w + xc);
    const int xr = static_cast<int16_t>(pk & 0xffff);
    const int yr = pk >> 16;
    // 3-4. clip the rectified row and the time bin, gather the X-map
    const int tb = t_bin[i];
    const int yg = min(max(yr, 0), xmap_h - 1);
    const int tg = min(max(tb, 0), xmap_w - 1);
    const int xp = __ldg(x_map + static_cast<long>(yg) * xmap_w + tg);
    // 5. disparity and the inlier mask (disparity.py:299-309)
    const int disp = xp - xr - xmaps::X_OFFSET;
    inlier = valid[i] && yr >= 0 && yr < xmap_h - 1 && disp >= 0 &&
             tb >= 0 && tb < xmap_w;
    if (xr_out) {
      xr_out[i] = xr;
      yr_out[i] = yr;
      xproj_out[i] = xp;
    }
    // 6. target: the projector-view pixel (yr, xr + disp) shifted by the
    //    crop origin, or the raw camera pixel (y, x)
    const int ty = (camera_view ? yi : yr) - oy;
    const int tx = (camera_view ? xi : xr + disp) - ox;
    const bool keep = inlier && ty >= 0 && ty < out_h && tx >= 0 &&
                      tx < out_w && disp < static_cast<int>(xmaps::PACK);
    if (keep) {
      const uint32_t p = static_cast<uint32_t>(prio ? prio[i] : i);
      atomicMax(packed_map + static_cast<long>(ty) * out_w + tx,
                (p + 1u) * xmaps::PACK + static_cast<uint32_t>(disp));
    }
  }
  // 7. inlier count: one atomic per warp
  const unsigned mask = __ballot_sync(0xffffffffu, inlier);
  if ((threadIdx.x & 31) == 0 && mask != 0u) {
    atomicAdd(inlier_count, __popc(mask));
  }
}

}  // namespace

extern "C" int event_disparity_scatter(
    const int32_t* x, const int32_t* y, const int32_t* t_bin, const bool* valid,
    const int32_t* prio, int n, const int32_t* cam_lut, int cam_h, int cam_w,
    const int16_t* x_map, int xmap_h, int xmap_w, int camera_view, int oy,
    int ox, int out_h, int out_w, int32_t* packed_map, int32_t* inlier_count,
    int32_t* xr_out, int32_t* yr_out, int32_t* xproj_out, cudaStream_t stream) {
  constexpr int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    event_disparity_scatter_kernel<<<blocks, threads, 0, stream>>>(
        x, y, t_bin, valid, prio, n, cam_lut, cam_h, cam_w, x_map, xmap_h,
        xmap_w, camera_view, oy, ox, out_h, out_w,
        reinterpret_cast<uint32_t*>(packed_map), inlier_count, xr_out, yr_out,
        xproj_out);
  }
  return static_cast<int>(cudaGetLastError());
}
