// Designs of kernel 1 (event_disparity_scatter), kept to time them against
// the one the port ships (xmaps_tpu_torch/csrc/events.cu).
// experiments/kernel1_designs.py builds this file, checks every design that
// computes the whole function bit-equal to the plain version and times them
// in turns.  Each entry runs the staged lane source: one frame's 1-word
// batch and its host count (frames == 1 and counts null), or F frames'
// (F, cap) rows and their device counts.
//
//   design_previous   kernel 1 before this redesign, verbatim (namespace
//                     previous; the C entry is new): each thread's first lane
//                     gathered, 16-byte zeros over the maps, one grid
//                     barrier, the atomics, and one same-address atomicAdd
//                     a warp and step into the F inlier counts.
//   design_ablation   the previous kernel with parts taken away, on its own
//                     grid: 0 an empty cooperative launch, 1 the same with
//                     one grid.sync(), 2 the zeroing and the barrier only, 3
//                     the lanes' loads and gathers with no atomicMax and no
//                     count (each thread folds its keys and words into one
//                     value, stored only if it equals a constant, so no load
//                     is dropped), 4 the lanes with their atomicMax and no
//                     inlier count.  Their maps and counts are not the
//                     function's.
//   design_candidate  the redesign's parts, each alone and combined:
//                     (a) inlier counts summed in shared memory, one
//                     atomicAdd a block, frame and step of K lanes;
//                     (b) the grid barrier replaced by readiness flags: each
//                     block zeroes its share, then releases its flag with the
//                     call's epoch; a lane acquires the flag of the block
//                     that zeroed its word before its atomicMax;
//                     (b') the zeroing on zero warps (ZW of a block's 8), in
//                     chunks of 128 vectors in frame order, each chunk's flag
//                     released as it is done, while the other warps gather
//                     their lanes frame-major and scatter each lane as soon
//                     as its chunk is ready;
//                     (c) K lanes a thread loaded and gathered before the
//                     zeroing (K = 1: the first lane only, as before).
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace previous {

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

// A step's inliers, one atomicAdd for each frame the warp's lanes hold (one
// frame in a one-frame launch); every lane of the warp calls it.
__device__ __forceinline__ void count_frames(const Target& g, const Scatter& s) {
  const unsigned peers = __match_any_sync(0xffffffffu, s.f);
  const unsigned ones = __ballot_sync(0xffffffffu, s.inlier) & peers;
  if (ones != 0u && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(g.inlier_count + s.f, __popc(ones));
  }
}

template <class Src>
__global__ void __launch_bounds__(THREADS)
    event_disparity_scatter_kernel(Src src, Target g) {
  // the thread's first lane, loaded and gathered before the zeroing
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const Scatter s0 = first < src.n ? prepare_lane(src, g, first) : no_lane();
  // phase A: 16-byte zeros over the maps (torch allocations are 16-byte
  // aligned), a scalar ragged tail, the counts; then one grid barrier
  const long words = static_cast<long>(g.frames) * g.out_h * g.out_w;
  int4* v = reinterpret_cast<int4*>(g.packed_map);
  const long nv = words / 4;
  for (long k = first; k < nv; k += stride) v[k] = make_int4(0, 0, 0, 0);
  for (long k = 4 * nv + first; k < words; k += stride) g.packed_map[k] = 0u;
  for (int k = first; k < g.frames; k += stride) g.inlier_count[k] = 0;
  cg::this_grid().sync();
  // phase B: the first lane's atomic, then the other lanes grid-stride (none
  // where the grid covers the events); the loop bound is uniform over a
  // block, so every lane of a warp meets each step's count
  commit(g, s0);
  count_frames(g, s0);
  for (int base = blockIdx.x * blockDim.x + stride; base < src.n; base += stride) {
    const int i = base + threadIdx.x;
    const Scatter s = i < src.n ? prepare_lane(src, g, i) : no_lane();
    commit(g, s);
    count_frames(g, s);
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

}  // namespace previous

namespace ablation {

using namespace previous;

enum Mode { EMPTY = 0, EMPTY_SYNC = 1, ZERO_ONLY = 2, GATHER_ONLY = 3, NO_COUNT = 4 };

// The previous kernel with parts taken away (Mode); the same grid.
template <class Src, int MODE>
__global__ void __launch_bounds__(THREADS)
    ablation_kernel(Src src, Target g, uint32_t* __restrict__ sink) {
  if (MODE == EMPTY) return;
  if (MODE == EMPTY_SYNC) {
    cg::this_grid().sync();
    return;
  }
  constexpr bool lanes = MODE >= GATHER_ONLY;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const Scatter s0 = lanes && first < src.n ? prepare_lane(src, g, first) : no_lane();
  const long words = static_cast<long>(g.frames) * g.out_h * g.out_w;
  int4* v = reinterpret_cast<int4*>(g.packed_map);
  const long nv = words / 4;
  for (long k = first; k < nv; k += stride) v[k] = make_int4(0, 0, 0, 0);
  for (long k = 4 * nv + first; k < words; k += stride) g.packed_map[k] = 0u;
  for (int k = first; k < g.frames; k += stride) g.inlier_count[k] = 0;
  cg::this_grid().sync();
  if (!lanes) return;
  uint32_t fold = 0u;
  if (MODE == GATHER_ONLY) {
    fold ^= s0.key ^ static_cast<uint32_t>(s0.word) ^ static_cast<uint32_t>(s0.inlier);
  } else {
    commit(g, s0);
  }
  for (int base = blockIdx.x * blockDim.x + stride; base < src.n; base += stride) {
    const int i = base + threadIdx.x;
    const Scatter s = i < src.n ? prepare_lane(src, g, i) : no_lane();
    if (MODE == GATHER_ONLY) {
      fold ^= s.key ^ static_cast<uint32_t>(s.word) ^ static_cast<uint32_t>(s.inlier);
    } else {
      commit(g, s);
    }
  }
  // one store a thread at most: the loads stay live, no bytes move
  if (MODE == GATHER_ONLY && fold == 0x9e3779b9u) sink[first] = fold;
}

template <class Src, int MODE>
int launch(const Src& src, const Target& g, uint32_t* sink, cudaStream_t stream) {
  static int cached[64] = {};
  const void* kernel = (const void*)ablation_kernel<Src, MODE>;
  int resident = 0;
  const int err = resident_blocks(kernel, cached, &resident);
  if (err != cudaSuccess) return err;
  // the previous kernel's grid
  const long vecs = (static_cast<long>(g.frames) * g.out_h * g.out_w + 3) / 4;
  const long work = std::max(static_cast<long>(src.n),
                             (vecs + ZERO_VECS_PER_THREAD - 1) / ZERO_VECS_PER_THREAD);
  const long want = std::max(1L, (work + THREADS - 1) / THREADS);
  const int blocks = static_cast<int>(std::min(want, static_cast<long>(resident)));
  Src s = src;
  Target t = g;
  void* args[] = {&s, &t, &sink};
  const cudaError_t e =
      cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace ablation

namespace candidate {

using namespace previous;

// A call's readiness flags, each set to the call's epoch once its zeroing is
// done: flags[0] the counts under (b'); flags[1 + u] zero unit u, the block
// u's whole share under (b) (block 0's covers the counts) or chunk u of
// `chunk` vectors under (b').
struct Ready {
  uint32_t* flags;
  uint32_t epoch;
  long chunk;
};

// 16-byte stores a thread: the grid's sizing under (b) and no barrier, and
// a zero warp's chunk under (b')
constexpr long ZERO_VECS = 4;
constexpr long CHUNK = 32 * ZERO_VECS;

__device__ __forceinline__ void release_flag(uint32_t* flag, uint32_t epoch) {
  __threadfence();
  asm volatile("st.global.release.gpu.b32 [%0], %1;" ::"l"(flag), "r"(epoch) : "memory");
}

// Spins until the flag holds the epoch; traps after ~2^22 polls (seconds),
// which no legal schedule reaches, so a fault ends as an error, not a hang.
__device__ __forceinline__ void wait_flag(const uint32_t* flag, uint32_t epoch) {
  for (unsigned spins = 0;; ++spins) {
    uint32_t v;
    asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
    if (v == epoch) return;
    if (spins > (1u << 22)) __trap();
    __nanosleep(32);
  }
}

template <class Src>
__device__ __forceinline__ int frame_of(const Src&, int) {
  return 0;
}
template <class Inner>
__device__ __forceinline__ int frame_of(const FrameLanes<Inner>& src, int i) {
  return i / src.cap;
}

// Vector k of the maps as 16-byte zeros; the last one of a word count that
// is no multiple of 4 as single words.
__device__ __forceinline__ void zero_vec(const Target& g, long k, long words) {
  if (4 * k + 4 <= words) {
    reinterpret_cast<int4*>(g.packed_map)[k] = make_int4(0, 0, 0, 0);
  } else {
    for (long w = 4 * k; w < words; ++w) g.packed_map[w] = 0u;
  }
}

template <int SYNC>
__device__ __forceinline__ const uint32_t* owner_flag(const Ready& rd, long word) {
  const long k = word >> 2;
  if (SYNC == 1) return rd.flags + 1 + (k / THREADS) % gridDim.x;
  return rd.flags + 1 + k / rd.chunk;
}

template <int SYNC>
__device__ __forceinline__ const uint32_t* counts_flag(const Ready& rd) {
  return SYNC == 1 ? rd.flags + 1 : rd.flags;
}

// BLOCK_COUNT (a); SYNC 0: the grid barrier, 1: flags a block (b), 2: zero
// warps and flags a chunk (b'); K lanes a thread gathered up front (c);
// ZW zero warps a block (SYNC 2 only).
template <class Src, bool BLOCK_COUNT, int SYNC, int K, int ZW>
__global__ void __launch_bounds__(THREADS)
    candidate_kernel(Src src, Target g, Ready rd) {
  constexpr int L = THREADS - 32 * ZW;  // lane threads a block
  __shared__ int cnt[BLOCK_COUNT ? K : 1][BLOCK_COUNT ? L : 1];
  const long words = static_cast<long>(g.frames) * g.out_h * g.out_w;
  const long nvec = (words + 3) / 4;
  const bool zero_warp = static_cast<int>(threadIdx.x) < 32 * ZW;
  const int lt = static_cast<int>(threadIdx.x) - 32 * ZW;
  const int nlt = gridDim.x * L;
  const int lbase = blockIdx.x * L;
  const int lane = threadIdx.x & 31;
  if constexpr (BLOCK_COUNT) {
    for (int k = threadIdx.x; k < K * L; k += THREADS) (&cnt[0][0])[k] = 0;
    __syncthreads();
  }
  // (c): the thread's first K lanes, loaded and gathered (and counted in
  // shared memory under (a)) before anything waits
  Scatter s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = no_lane();
  if (!zero_warp) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lbase + k * nlt + lt;
      s[k] = i < src.n ? prepare_lane(src, g, i) : no_lane();
      if constexpr (BLOCK_COUNT) {
        // step k's L lanes span frames f0 .. f0 + L - 1 at most
        const int f0 = frame_of(src, lbase + k * nlt);
        const unsigned peers = __match_any_sync(0xffffffffu, s[k].f);
        const unsigned ones = __ballot_sync(0xffffffffu, s[k].inlier) & peers;
        if (ones != 0u && lane == __ffs(peers) - 1) atomicAdd(&cnt[k][s[k].f - f0], __popc(ones));
      }
    }
  }
  if (SYNC != 2) {
    const int stride = gridDim.x * THREADS;
    const int first = blockIdx.x * THREADS + threadIdx.x;
    for (long k = first; k < nvec; k += stride) zero_vec(g, k, words);
    if (blockIdx.x == 0) {
      for (int f = threadIdx.x; f < g.frames; f += THREADS) g.inlier_count[f] = 0;
    }
    if (SYNC == 0) {
      cg::this_grid().sync();
    } else {
      __syncthreads();
      if (threadIdx.x == 0) release_flag(rd.flags + 1 + blockIdx.x, rd.epoch);
    }
  } else if (zero_warp) {
    const int warp = threadIdx.x >> 5;
    if (blockIdx.x == 0 && warp == 0) {
      for (int f = lane; f < g.frames; f += 32) g.inlier_count[f] = 0;
      __syncwarp();
      if (lane == 0) release_flag(rd.flags, rd.epoch);
    }
    const long nchunk = (nvec + rd.chunk - 1) / rd.chunk;
    for (long c = static_cast<long>(blockIdx.x) * ZW + warp; c < nchunk;
         c += static_cast<long>(gridDim.x) * ZW) {
      const long end = (c + 1) * rd.chunk < nvec ? (c + 1) * rd.chunk : nvec;
      for (long k = c * rd.chunk + lane; k < end; k += 32) zero_vec(g, k, words);
      __syncwarp();
      if (lane == 0) release_flag(rd.flags + 1 + c, rd.epoch);
    }
  }
  if (!zero_warp) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (SYNC != 0 && s[k].word >= 0) wait_flag(owner_flag<SYNC>(rd, s[k].word), rd.epoch);
      commit(g, s[k]);
    }
    const bool more = lbase + K * nlt < src.n;
    if (SYNC != 0 && (!BLOCK_COUNT || more)) wait_flag(counts_flag<SYNC>(rd), rd.epoch);
    if constexpr (!BLOCK_COUNT) {
#pragma unroll
      for (int k = 0; k < K; ++k) count_frames(g, s[k]);
    }
    // lanes past the first K steps, one at a time, counted a warp and step
    for (int base = lbase + K * nlt; base < src.n; base += nlt) {
      const int i = base + lt;
      const Scatter x = i < src.n ? prepare_lane(src, g, i) : no_lane();
      if (SYNC != 0 && x.word >= 0) wait_flag(owner_flag<SYNC>(rd, x.word), rd.epoch);
      commit(g, x);
      count_frames(g, x);
    }
  }
  if constexpr (BLOCK_COUNT) {
    __syncthreads();
    if (SYNC != 0) wait_flag(counts_flag<SYNC>(rd), rd.epoch);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int base = lbase + k * nlt;
      if (base >= src.n) break;
      const int f0 = frame_of(src, base);
      for (int t = threadIdx.x; t < L; t += THREADS) {
        const int c = cnt[k][t];
        if (c != 0) atomicAdd(g.inlier_count + f0 + t, c);
      }
    }
  }
}

template <class Src, bool BLOCK_COUNT, int SYNC, int K, int ZW>
int launch(const Src& src, const Target& g, uint32_t* flags, int n_flags, uint32_t epoch,
           cudaStream_t stream) {
  static int cached[64] = {};
  const void* kernel = (const void*)candidate_kernel<Src, BLOCK_COUNT, SYNC, K, ZW>;
  int resident = 0;
  const int err = resident_blocks(kernel, cached, &resident);
  if (err != cudaSuccess) return err;
  constexpr int L = THREADS - 32 * ZW;
  const long nvec = (static_cast<long>(g.frames) * g.out_h * g.out_w + 3) / 4;
  Ready rd{flags, epoch, CHUNK};
  long zero_blocks;
  if (SYNC == 2) {
    if (n_flags < 2) return cudaErrorInvalidValue;
    const long units = static_cast<long>(n_flags - 1) * CHUNK;
    rd.chunk = CHUNK * std::max(1L, (nvec + units - 1) / units);
    zero_blocks = ((nvec + rd.chunk - 1) / rd.chunk + ZW - 1) / ZW;
  } else {
    zero_blocks = (nvec + THREADS * ZERO_VECS - 1) / (THREADS * ZERO_VECS);
  }
  const long lane_blocks = (static_cast<long>(src.n) + L - 1) / L;
  const long want = std::max(1L, std::max(zero_blocks, lane_blocks));
  const int blocks = static_cast<int>(std::min(want, static_cast<long>(resident)));
  if (SYNC == 1 && blocks + 1 > n_flags) return cudaErrorInvalidValue;
  Src s = src;
  Target t = g;
  void* args[] = {&s, &t, &rd};
  const cudaError_t e =
      cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace candidate

namespace {

// The staged lane source of an entry: one frame's words and host count
// (counts null), or F frames' (F, cap) rows and their device counts.
template <class Fn>
int with_source(const int32_t* word, const int32_t* counts, int frames, int cap, int count,
                int bits_x, int bits_y, int bits_t, Fn&& fn) {
  using previous::StagedLanes;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(word);
  if (counts == nullptr) {
    if (frames != 1 || count < 0 || count > cap) return cudaErrorInvalidValue;
    return fn(StagedLanes{w, count, bits_x, bits_y, bits_t});
  }
  if (frames < 1 || cap < 1) return cudaErrorInvalidValue;
  const StagedLanes rows{w, cap, bits_x, bits_y, bits_t};
  return fn(previous::FrameLanes<StagedLanes>{rows, cap, frames * cap, counts});
}

}  // namespace

#define DESIGN_ARGS                                                                   \
  const int32_t *word, const int32_t *counts, int frames, int cap, int count,        \
      int bits_x, int bits_y, int bits_t, const int32_t *cam_lut, int cam_h,         \
      int cam_w, const int16_t *x_map, int xmap_h, int xmap_w, int camera_view,      \
      int oy, int ox, int out_h, int out_w, int32_t *maps, int32_t *inliers
#define DESIGN_TARGET                                                                 \
  previous::target(cam_lut, cam_h, cam_w, x_map, xmap_h, xmap_w, camera_view, oy, ox, \
                   out_h, out_w, maps, inliers, frames)
#define DESIGN_SOURCE word, counts, frames, cap, count, bits_x, bits_y, bits_t

extern "C" int design_previous(DESIGN_ARGS, cudaStream_t stream) {
  const previous::Target g = DESIGN_TARGET;
  return with_source(DESIGN_SOURCE,
                     [&](const auto& src) { return previous::launch(src, g, stream); });
}

// sink: at least the co-resident grid's threads of uint32 (mode 3's store)
extern "C" int design_ablation(int mode, DESIGN_ARGS, uint32_t* sink, cudaStream_t stream) {
  const previous::Target g = DESIGN_TARGET;
  return with_source(DESIGN_SOURCE, [&](const auto& src) -> int {
    using S = std::decay_t<decltype(src)>;
    switch (mode) {
      case 0: return ablation::launch<S, 0>(src, g, sink, stream);
      case 1: return ablation::launch<S, 1>(src, g, sink, stream);
      case 2: return ablation::launch<S, 2>(src, g, sink, stream);
      case 3: return ablation::launch<S, 3>(src, g, sink, stream);
      case 4: return ablation::launch<S, 4>(src, g, sink, stream);
    }
    return cudaErrorInvalidValue;
  });
}

// variant: 0 (a), 1 (b), 2 (c), 3 (a)+(b), 4 (a)+(c), 5 (b)+(c), 6 (a)+(b)+(c),
// 7 (a)+(b')+(c) with 4 zero warps, 8 the same with 2, 9 (a)+(b') with 4 and
// K = 1.  flags: n_flags uint32 words, zero before the first call; epoch:
// one more than the last call's on these flags.
extern "C" int design_candidate(int variant, DESIGN_ARGS, uint32_t* flags, int n_flags,
                                uint32_t epoch, cudaStream_t stream) {
  const previous::Target g = DESIGN_TARGET;
  return with_source(DESIGN_SOURCE, [&](const auto& src) -> int {
    using S = std::decay_t<decltype(src)>;
    switch (variant) {
      case 0: return candidate::launch<S, true, 0, 1, 0>(src, g, flags, n_flags, epoch, stream);
      case 1: return candidate::launch<S, false, 1, 1, 0>(src, g, flags, n_flags, epoch, stream);
      case 2: return candidate::launch<S, false, 0, 4, 0>(src, g, flags, n_flags, epoch, stream);
      case 3: return candidate::launch<S, true, 1, 1, 0>(src, g, flags, n_flags, epoch, stream);
      case 4: return candidate::launch<S, true, 0, 4, 0>(src, g, flags, n_flags, epoch, stream);
      case 5: return candidate::launch<S, false, 1, 4, 0>(src, g, flags, n_flags, epoch, stream);
      case 6: return candidate::launch<S, true, 1, 4, 0>(src, g, flags, n_flags, epoch, stream);
      case 7: return candidate::launch<S, true, 2, 4, 4>(src, g, flags, n_flags, epoch, stream);
      case 8: return candidate::launch<S, true, 2, 4, 2>(src, g, flags, n_flags, epoch, stream);
      case 9: return candidate::launch<S, true, 2, 1, 4>(src, g, flags, n_flags, epoch, stream);
    }
    return cudaErrorInvalidValue;
  });
}
