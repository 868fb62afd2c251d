// Kernel 1: event_disparity_scatter -- per-event rectify + X-map gather +
// disparity + last-write-wins scatter of one frame, in one pass.
//
// Replaces the TPU kernels rectify_and_lookup (xmaps_tpu/ops/pallas_events.py:508)
// and rectify_and_lookup_hbm (:422) together with the XLA disparity/inlier
// math (xmaps_tpu/ops/disparity.py:299-309) and the packed scatter
// (xmaps_tpu/ops/scatter.py, method "max"/"sorted").
//
// What bounds it on the H100, measured (experiments/kernel1_designs.py:
// ablations of the previous design, L2 flushed before each call; PERF.md
// section 6): at the demonstrator, a group of 12 frames took 31.0 us,
// of which the cooperative launch 1.5, the grid barrier 2.2, the zeroing of
// the 23 MB of maps 7.4 (3.1 TB/s: the bytes' rate) and the lanes 20.0; of
// the lanes, the dependent gather chains 5.9, the atomicMax scatter 3.2 and
// the inlier count 10.9 -- one same-address atomicAdd a warp and step, ~10.7k
// of them onto 48 bytes, which serialise in one L2 slice.  At the ESL rig
// (42.6 MB of maps, a 12.4 MB X-map) the count took 23.5 of 55.5 us.  One
// frame took 5.9 us, 2.0 of them the launch and the barrier.  Both tables
// fit in the 50 MB L2 (camera LUT 1.2 MB; X-map 1.9 MB at the demonstrator,
// 12.4 MB at the ESL rig).
//
// What the design does about it: one thread per event lane, tables read
// through the read-only path straight from global memory / L2.  The TPU
// kernel's y-sort and VMEM row banding existed because a TPU gather is a
// serial scalar loop; here the hardware gathers, so there is no sort and no
// band plan, and any capacity works (no 1024-lane blocking).  Determinism
// comes from the packed key (prio + 1) * PACK + disp: atomicMax keeps the
// highest priority per pixel, which is NumPy's last-write-wins regardless
// of the order in which threads run.  The priority is the lane index (plus
// the array entries' index_offset: an event shard's first lane in its
// frame), or with a dedup frame filter (ops/filters.py) the lane's dense
// raster rank, read from an optional per-lane int32 array (< capacity).  The key is
// unsigned 32-bit, as in the JAX package, so capacities up to 524286 lanes
// fit (the offline eval's whole-image batch is 307200); the map is handed
// over as int32 words.
//
// The inlier counts are summed in shared memory: each warp adds its
// inliers a frame to the block's counter of that frame (the frame less the
// step's first frame: a block's 256 lanes of a step span at most 256
// frames, at any capacity), and each block adds each non-zero counter to
// its frame's count once, at its end: one global atomicAdd a block, frame
// and up-front step in place of one a warp and step.  Sums are order-free:
// the counts stay exact.
//
// The map and the count are zeroed inside the launch: a cooperative grid,
// sized to be co-resident, loads, gathers and counts its first K lanes a
// thread (nothing of that touches the map or the counts: K = 4 in the group
// entries, whose F x cap lanes outrun the grid's threads, K = 1 in the
// one-frame entries, whose lanes the grid covers), stores 16-byte zeros
// over the map, meets at one grid barrier, then does those lanes' atomics
// and the remaining lanes in a grid-stride loop (counted a warp and step
// straight into the counts): the gather chains' latency hides under the
// zeroing.  K = 4 takes the group kernels to 40 registers, 6 blocks of 256
// an SM in place of 8; the experiment's (a)+(c), this design in 30
// registers (8 blocks), measured 6 % slower (fewer blocks meet at the
// barrier, which cost 1.1 us at 117 blocks and 2.2 us at 1056).
// (cudaMemsetAsync of both before a plain launch measured slower on the
// H100.)  Measured and not shipped: readiness flags in place of the
// barrier -- a block's flag, or zero warps releasing the maps chunk by
// chunk in frame order beside lane warps -- were 1.4-3.3x slower in the
// group: an acquire poll a lane cost more than the 2.2 us barrier it
// replaced.
//
// Three entries share the per-lane device function: the array entry (x, y,
// time bin, valid, optional priority and lane outputs); the staged entry,
// which reads the streaming path's one 32-bit word an event (x | y << bx |
// t_bin << (bx + by), ops/staged.py CompactLayout) and a host count, and
// decodes the lane in registers (4 B an event in place of 13); and the ring
// entry, which reads the frame straight from the k <= 8 device rows of the
// packet ring (io/prefetch.py PacketRing, ops/staged.py RingLayout: x | y <<
// bx | t_rel << (bx + by), t_rel relative to the packet's first event).  Its
// placement (each packet's row, start lane, cumulative offset and time
// offset), the count and the frame's time bounds are kernel arguments, so
// nothing crosses the link at dispatch.  Each lane finds its packet with a
// compare over the cumulative offsets, in registers, and bins its time t_rel
// + t_off exactly as ops/disparity.py _scale_time_int does (int32, floor
// division, round half to even) from the host's masked min/max.
//
// The group entries run F independent frames in ONE cooperative launch (the
// counterpart of the JAX engine's process_frames program): the array and
// the staged lane sources over (F, capacity) rows, wrapped by FrameLanes,
// which maps group lane i to frame f = i / capacity and lane j = i %
// capacity.  Phase A zeroes the F maps (contiguous, (F, out_h, out_w)) and
// the F counts before the one grid barrier.  A lane scatters into map f
// with the key of its lane within the frame, (j + 1) * PACK + disp, so each
// map equals its frame's single-frame launch bit for bit (and the key fits
// 32 bits at any F).  A staged frame's lanes at or past its count, read
// from the (F,) device counts, are not loaded.  A warp may hold lanes of
// two or more frames (a capacity that is not a multiple of 32, or the
// grid-stride step), so every entry sums the inliers per frame with one
// __match_any_sync a step (one frame's entries: one frame a step).
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
// phase A's 16-byte stores a thread, in the grid size of a cooperative launch
constexpr long ZERO_VECS_PER_THREAD = 4;

struct Lane {
  int x, y, tb;
  bool valid;
  uint32_t prio;
};

// Where lane i of the launch's walk lies: its frame f (0 in a one-frame
// launch), its lane j within the frame, and whether it is read at all.
struct Slot {
  int f, j;
  bool live;
};

// Each lane source loads flat lane i of its arrays with the priority of
// lane j of its frame; in a one-frame source lane i is lane i of frame 0.
template <class Src>
__device__ __forceinline__ Slot slot_of(const Src&, int i) {
  return Slot{0, i, true};
}

// The per-lane inputs of the array entry.
struct ArrayLanes {
  const int32_t* __restrict__ x;
  const int32_t* __restrict__ y;
  const int32_t* __restrict__ t_bin;
  const bool* __restrict__ valid;
  const int32_t* __restrict__ prio;  // nullable: the lane index + offset
  int32_t* __restrict__ xr_out;      // nullable, with yr_out and xproj_out
  int32_t* __restrict__ yr_out;
  int32_t* __restrict__ xproj_out;
  int n;
  int offset;  // an event shard's first lane in its frame (0: the whole frame)

  __device__ __forceinline__ Lane load(int i, int j) const {
    return Lane{x[i], y[i], t_bin[i], valid[i],
                static_cast<uint32_t>(prio ? prio[i] : j + offset)};
  }
  __device__ __forceinline__ void store(int i, int xr, int yr, int xp) const {
    if (xr_out) {
      xr_out[i] = xr;
      yr_out[i] = yr;
      xproj_out[i] = xp;
    }
  }
};

// The 1-word staged batch: lanes below the count are valid and only they
// are read.  Decoded as uint32: bit 31 is set where the widths sum to 32.
struct StagedLanes {
  const uint32_t* __restrict__ word;
  int n;  // the host count
  int bits_x, bits_y, bits_t;

  __device__ __forceinline__ Lane load(int i, int j) const {
    const uint32_t w = __ldg(word + i);
    const uint32_t mx = (1u << bits_x) - 1u;
    const uint32_t my = (1u << bits_y) - 1u;
    const uint32_t mt = (1u << bits_t) - 1u;
    return Lane{static_cast<int>(w & mx), static_cast<int>((w >> bits_x) & my),
                static_cast<int>((w >> (bits_x + bits_y)) & mt), true,
                static_cast<uint32_t>(j)};
  }
  __device__ __forceinline__ void store(int, int, int, int) const {}
};

// The frame as k <= RING_MAX_PACKETS packets of the device ring: packet j
// holds lanes [cum0[j], cum0[j + 1]) of the frame, at lanes [start[j], ...)
// of its row.  Lanes below the host count are valid and only they are read.
constexpr int RING_MAX_PACKETS = 8;

struct RingLanes {
  const uint32_t* row[RING_MAX_PACKETS];
  int start[RING_MAX_PACKETS];
  int cum0[RING_MAX_PACKETS];
  int t_off[RING_MAX_PACKETS];
  int k;
  int n;  // the host count, min(frame events, capacity)
  int bits_x, bits_y;
  int t_min, t_max, t_px_scale;

  __device__ __forceinline__ Lane load(int i, int) const {
    // the lane's packet: the last one whose cumulative offset is <= i,
    // selected with compile-time indices (registers, no local array)
    const uint32_t* r = row[0];
    int lane = i - cum0[0] + start[0];
    int off = t_off[0];
#pragma unroll
    for (int j = 1; j < RING_MAX_PACKETS; ++j) {
      if (j < k && i >= cum0[j]) {
        r = row[j];
        lane = i - cum0[j] + start[j];
        off = t_off[j];
      }
    }
    const uint32_t w = __ldg(r + lane);
    const int shift = bits_x + bits_y;
    const int x = static_cast<int>(w & ((1u << bits_x) - 1u));
    const int y = static_cast<int>((w >> bits_x) & ((1u << bits_y) - 1u));
    // logical shift: bit 31 is set at 640 x 480 (10 + 9 + 13 bits)
    const int t = static_cast<int>(w >> shift) + off;
    // _scale_time_int: round half to even of (t - min) * scale / range
    const int rng = max(t_max - t_min, 1);
    const int num = (t - t_min) * t_px_scale;
    int q = num / rng;
    if (num % rng != 0 && num < 0) --q;  // floor division (rng >= 1)
    const int rem = num - q * rng;
    const int twice = 2 * rem;
    const bool up = twice > rng || (twice == rng && (q & 1));
    return Lane{x, y, q + static_cast<int>(up), true, static_cast<uint32_t>(i)};
  }
  __device__ __forceinline__ void store(int, int, int, int) const {}
};

// F frames of `cap` lanes each, as (F, cap) rows of an array or staged
// source: group lane i is lane j = i % cap of frame f = i / cap.  With
// `counts` (the staged rows' (F,) device counts) only a frame's lanes below
// its count are read.
template <class Inner>
struct FrameLanes {
  Inner inner;
  int cap;
  int n;  // F * cap
  const int32_t* __restrict__ counts;  // nullable: every lane is read

  __device__ __forceinline__ Lane load(int i, int j) const { return inner.load(i, j); }
  __device__ __forceinline__ void store(int i, int xr, int yr, int xp) const {
    inner.store(i, xr, yr, xp);
  }
};

template <class Inner>
__device__ __forceinline__ Slot slot_of(const FrameLanes<Inner>& src, int i) {
  const int f = i / src.cap;
  const int j = i - f * src.cap;
  return Slot{f, j, src.counts == nullptr || j < __ldg(src.counts + f)};
}

struct Target {
  const int32_t* __restrict__ cam_lut;
  int cam_h, cam_w;
  const int16_t* __restrict__ x_map;
  int xmap_h, xmap_w;
  int camera_view, oy, ox, out_h, out_w;
  int frames;  // F maps of out_h * out_w words and F counts, contiguous
  uint32_t* __restrict__ packed_map;
  int32_t* __restrict__ inlier_count;
};

// One lane's scatter, prepared: its inlier bit, the map word and packed key
// of its atomicMax (word -1: no store), and its frame (-1: no lane).
struct Scatter {
  bool inlier;
  long word;
  uint32_t key;
  int f;
};

__device__ __forceinline__ Scatter no_lane() { return Scatter{false, -1L, 0u, -1}; }

// One lane: rectify, X-map gather, disparity, inlier mask, the packed key
// and its target word; nothing of it touches the map.
template <class Src>
__device__ __forceinline__ Scatter prepare_lane(const Src& src, const Target& g, int i) {
  const Slot at = slot_of(src, i);
  if (!at.live) return Scatter{false, -1L, 0u, at.f};
  const Lane e = src.load(i, at.j);
  // 1-2. clip the raw coordinates, gather from the packed camera LUT
  //      (mapy << 16 | mapx & 0xffff) and sign-extend both i16 halves
  const int yc = min(max(e.y, 0), g.cam_h - 1);
  const int xc = min(max(e.x, 0), g.cam_w - 1);
  const int32_t pk = __ldg(g.cam_lut + yc * g.cam_w + xc);
  const int xr = static_cast<int16_t>(pk & 0xffff);
  const int yr = pk >> 16;
  // 3-4. clip the rectified row and the time bin, gather the X-map
  const int yg = min(max(yr, 0), g.xmap_h - 1);
  const int tg = min(max(e.tb, 0), g.xmap_w - 1);
  const int xp = __ldg(g.x_map + static_cast<long>(yg) * g.xmap_w + tg);
  // 5. disparity and the inlier mask (disparity.py:299-309)
  const int disp = xp - xr - xmaps::X_OFFSET;
  const bool inlier = e.valid && yr >= 0 && yr < g.xmap_h - 1 && disp >= 0 &&
                      e.tb >= 0 && e.tb < g.xmap_w;
  src.store(i, xr, yr, xp);
  // 6. target: the projector-view pixel (yr, xr + disp) shifted by the
  //    crop origin, or the raw camera pixel (y, x)
  const int ty = (g.camera_view ? e.y : yr) - g.oy;
  const int tx = (g.camera_view ? e.x : xr + disp) - g.ox;
  const bool keep = inlier && ty >= 0 && ty < g.out_h && tx >= 0 && tx < g.out_w &&
                    disp < static_cast<int>(xmaps::PACK);
  const long frame0 = static_cast<long>(at.f) * g.out_h * g.out_w;
  return Scatter{inlier, keep ? frame0 + static_cast<long>(ty) * g.out_w + tx : -1L,
                 (e.prio + 1u) * xmaps::PACK + static_cast<uint32_t>(disp), at.f};
}

__device__ __forceinline__ void commit(const Target& g, const Scatter& s) {
  if (s.word >= 0) atomicMax(g.packed_map + s.word, s.key);
}

// Lanes a thread loads and gathers before the zeroing: the group entries'
// F x cap lanes outrun the co-resident grid, one frame's lanes do not.
template <class Src>
struct UpFront {
  static constexpr int K = 1;
};
template <class Inner>
struct UpFront<FrameLanes<Inner>> {
  static constexpr int K = 4;
};

// The frame of lane i of the walk (0 in a one-frame launch).
template <class Src>
__device__ __forceinline__ int frame_of(const Src&, int) {
  return 0;
}
template <class Inner>
__device__ __forceinline__ int frame_of(const FrameLanes<Inner>& src, int i) {
  return i / src.cap;
}

// A step's inliers, one atomicAdd for each frame the warp's lanes hold, into
// `counts` at the frame less `f0` (the block's shared counters, or the
// global counts with f0 = 0); every lane of the warp calls it.
__device__ __forceinline__ void count_frames(int32_t* counts, int f0, const Scatter& s) {
  const unsigned peers = __match_any_sync(0xffffffffu, s.f);
  const unsigned ones = __ballot_sync(0xffffffffu, s.inlier) & peers;
  if (ones != 0u && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(counts + (s.f - f0), __popc(ones));
  }
}

template <class Src>
__global__ void __launch_bounds__(THREADS)
    event_disparity_scatter_kernel(Src src, Target g) {
  constexpr int K = UpFront<Src>::K;
  // counts[k][j]: the block's inliers of frame j + (frame of its step k's
  // first lane)
  __shared__ int32_t counts[K][THREADS];
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = threadIdx.x; k < K * THREADS; k += THREADS) (&counts[0][0])[k] = 0;
  __syncthreads();
  // the thread's first K lanes, loaded, gathered and counted before the
  // zeroing (each step's loop bound is uniform over a block, so every lane
  // of a warp meets each count)
  Scatter s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = first + k * stride;
    s[k] = i < src.n ? prepare_lane(src, g, i) : no_lane();
    count_frames(counts[k], frame_of(src, i - static_cast<int>(threadIdx.x)), s[k]);
  }
  // phase A: 16-byte zeros over the maps (torch allocations are 16-byte
  // aligned), a scalar ragged tail, the counts; then one grid barrier
  const long words = static_cast<long>(g.frames) * g.out_h * g.out_w;
  int4* v = reinterpret_cast<int4*>(g.packed_map);
  const long nv = words / 4;
  for (long k = first; k < nv; k += stride) v[k] = make_int4(0, 0, 0, 0);
  for (long k = 4 * nv + first; k < words; k += stride) g.packed_map[k] = 0u;
  for (int k = first; k < g.frames; k += stride) g.inlier_count[k] = 0;
  cg::this_grid().sync();
  // phase B: the first K lanes' atomics, then the other lanes grid-stride
  // (none where K steps of the grid cover the events), counted a warp and
  // step into the counts
#pragma unroll
  for (int k = 0; k < K; ++k) commit(g, s[k]);
  for (int base = blockIdx.x * blockDim.x + K * stride; base < src.n; base += stride) {
    const int i = base + threadIdx.x;
    const Scatter x = i < src.n ? prepare_lane(src, g, i) : no_lane();
    commit(g, x);
    count_frames(g.inlier_count, 0, x);
  }
  // each of the block's counters into its frame's count, once
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int base = blockIdx.x * blockDim.x + k * stride;
    const int c = counts[k][threadIdx.x];
    if (base < src.n && c != 0) atomicAdd(g.inlier_count + frame_of(src, base) + threadIdx.x, c);
  }
}

// The co-resident grid of a cooperative launch on the current device,
// cached per device.
int resident_blocks(const void* kernel, int* cached, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0)) !=
            cudaSuccess) {
      return e;
    }
    if (!coop) return cudaErrorNotSupported;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached[dev] = per_sm * sms;
  }
  *out = cached[dev];
  return cudaSuccess;
}

// One cooperative launch, at most the co-resident grid; one block at least,
// so an empty frame still zeroes (and counts) its map.  The grid is sized by
// the larger of the lanes and the zeroing of all the launch's maps.  A
// refused launch returns its error.
template <class Src>
int launch(const Src& src, const Target& g, cudaStream_t stream) {
  static int cached[64] = {};
  const void* kernel = (const void*)event_disparity_scatter_kernel<Src>;
  int resident = 0;
  const int err = resident_blocks(kernel, cached, &resident);
  if (err != cudaSuccess) return err;
  const long vecs = (static_cast<long>(g.frames) * g.out_h * g.out_w + 3) / 4;
  const long work = std::max(static_cast<long>(src.n),
                             (vecs + ZERO_VECS_PER_THREAD - 1) / ZERO_VECS_PER_THREAD);
  const long want = std::max(1L, (work + THREADS - 1) / THREADS);
  const int blocks = static_cast<int>(std::min(want, static_cast<long>(resident)));
  Src s = src;
  Target t = g;
  void* args[] = {&s, &t};
  const cudaError_t e =
      cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args, 0, stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return e != cudaSuccess ? e : last;
}

Target target(const int32_t* cam_lut, int cam_h, int cam_w, const int16_t* x_map,
              int xmap_h, int xmap_w, int camera_view, int oy, int ox, int out_h,
              int out_w, int32_t* packed_map, int32_t* inlier_count, int frames = 1) {
  return Target{cam_lut, cam_h, cam_w, x_map, xmap_h, xmap_w, camera_view, oy, ox,
                out_h, out_w, frames, reinterpret_cast<uint32_t*>(packed_map),
                inlier_count};
}

}  // namespace

// index_offset: the first lane's priority without `prio` (an event shard's
// first lane in its frame, parallel/sharding.py; 0 for a whole frame), so
// the shards' maps combine into the frame's with an unsigned max.  The
// wrapper checks index_offset + n <= MAX_CAPACITY.
extern "C" int event_disparity_scatter(
    const int32_t* x, const int32_t* y, const int32_t* t_bin, const bool* valid,
    const int32_t* prio, int n, int index_offset, const int32_t* cam_lut, int cam_h,
    int cam_w, const int16_t* x_map, int xmap_h, int xmap_w, int camera_view, int oy,
    int ox, int out_h, int out_w, int32_t* packed_map, int32_t* inlier_count,
    int32_t* xr_out, int32_t* yr_out, int32_t* xproj_out, cudaStream_t stream) {
  if (index_offset < 0) return cudaErrorInvalidValue;
  const ArrayLanes src{x, y, t_bin, valid, prio, xr_out, yr_out, xproj_out, n, index_offset};
  return launch(src, target(cam_lut, cam_h, cam_w, x_map, xmap_h, xmap_w, camera_view,
                            oy, ox, out_h, out_w, packed_map, inlier_count),
                stream);
}

extern "C" int event_disparity_scatter_staged(
    const int32_t* word, int count, int bits_x, int bits_y, int bits_t,
    const int32_t* cam_lut, int cam_h, int cam_w, const int16_t* x_map, int xmap_h,
    int xmap_w, int camera_view, int oy, int ox, int out_h, int out_w,
    int32_t* packed_map, int32_t* inlier_count, cudaStream_t stream) {
  const StagedLanes src{reinterpret_cast<const uint32_t*>(word), count, bits_x, bits_y,
                        bits_t};
  return launch(src, target(cam_lut, cam_h, cam_w, x_map, xmap_h, xmap_w, camera_view,
                            oy, ox, out_h, out_w, packed_map, inlier_count),
                stream);
}

// rows: the k packets' device rows; pkt_start, pkt_count, pkt_t_off: host
// arrays of k int32, each packet's start lane in its row, its lanes of the
// frame and its time offset (io/prefetch.py PacketRing.frame_meta).  They
// are copied into the kernel's arguments here, on the host.
extern "C" int event_disparity_scatter_ring(
    const int32_t* const* rows, const int32_t* pkt_start, const int32_t* pkt_count,
    const int32_t* pkt_t_off, int k, int count, int bits_x, int bits_y, int t_min,
    int t_max, int t_px_scale, const int32_t* cam_lut, int cam_h, int cam_w,
    const int16_t* x_map, int xmap_h, int xmap_w, int camera_view, int oy, int ox,
    int out_h, int out_w, int32_t* packed_map, int32_t* inlier_count, cudaStream_t stream) {
  if (k < 1 || k > RING_MAX_PACKETS) return cudaErrorInvalidValue;
  RingLanes src{};
  int cum = 0;
  for (int j = 0; j < k; ++j) {
    src.row[j] = reinterpret_cast<const uint32_t*>(rows[j]);
    src.start[j] = pkt_start[j];
    src.cum0[j] = cum;
    src.t_off[j] = pkt_t_off[j];
    cum += pkt_count[j];
  }
  src.k = k;
  src.n = count;
  src.bits_x = bits_x;
  src.bits_y = bits_y;
  src.t_min = t_min;
  src.t_max = t_max;
  src.t_px_scale = t_px_scale;
  return launch(src, target(cam_lut, cam_h, cam_w, x_map, xmap_h, xmap_w, camera_view,
                            oy, ox, out_h, out_w, packed_map, inlier_count),
                stream);
}

// The group entries: F frames of `cap` lanes, (F, cap) rows, into F
// contiguous (out_h, out_w) maps and F counts, in one launch.  The array
// group's lane outputs are not written (no xr/yr/x_proj rows); its
// index_offset shifts each frame's lane index, as the one-frame entry's.
extern "C" int event_disparity_scatter_group(
    const int32_t* x, const int32_t* y, const int32_t* t_bin, const bool* valid,
    const int32_t* prio, int frames, int cap, int index_offset, const int32_t* cam_lut,
    int cam_h, int cam_w, const int16_t* x_map, int xmap_h, int xmap_w, int camera_view,
    int oy, int ox, int out_h, int out_w, int32_t* packed_maps, int32_t* inlier_counts,
    cudaStream_t stream) {
  if (frames < 1 || cap < 1 || index_offset < 0) return cudaErrorInvalidValue;
  const ArrayLanes rows{x, y, t_bin, valid, prio, nullptr, nullptr, nullptr, cap, index_offset};
  const FrameLanes<ArrayLanes> src{rows, cap, frames * cap, nullptr};
  return launch(src, target(cam_lut, cam_h, cam_w, x_map, xmap_h, xmap_w, camera_view,
                            oy, ox, out_h, out_w, packed_maps, inlier_counts, frames),
                stream);
}

// counts: the (F,) device counts of the staged rows (the group buffer's
// tail, io/prefetch.py stage_compact_group).
extern "C" int event_disparity_scatter_staged_group(
    const int32_t* word, const int32_t* counts, int frames, int cap, int bits_x, int bits_y,
    int bits_t, const int32_t* cam_lut, int cam_h, int cam_w, const int16_t* x_map,
    int xmap_h, int xmap_w, int camera_view, int oy, int ox, int out_h, int out_w,
    int32_t* packed_maps, int32_t* inlier_counts, cudaStream_t stream) {
  if (frames < 1 || cap < 1) return cudaErrorInvalidValue;
  const StagedLanes rows{reinterpret_cast<const uint32_t*>(word), cap, bits_x, bits_y,
                         bits_t};
  const FrameLanes<StagedLanes> src{rows, cap, frames * cap, counts};
  return launch(src, target(cam_lut, cam_h, cam_w, x_map, xmap_h, xmap_w, camera_view,
                            oy, ox, out_h, out_w, packed_maps, inlier_counts, frames),
                stream);
}
