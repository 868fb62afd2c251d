// Kernel F: frame_dedup_filter -- the four dedup frame filters of one frame
// (or of F frames, frame_dedup_filter_group) in one cooperative launch: the
// keep mask, the mean filter's rewritten time and the scatter priority that
// kernel 1 takes.
//
// Replaces the XLA stage xmaps_tpu/ops/filters.py:83 apply_frame_filter,
// which has no Pallas kernel: one stable lax.sort (the dense raster rank),
// a scatter-max into the key map and a gather.  The port ran it as 15-20
// torch launches a frame (ops/filters.py apply_frame_filter_plain: a sort,
// a fill of the whole key map, scatter_reduce_, gathers), and for
// first_per_yt two more gathers of the camera LUT (ops/disparity.py
// rectify_events).
//
// What bounds it: bytes, 18 B a lane (x, y, p in, valid in and out,
// priority out), 22 with first_per_yt's LUT read, 26 with the mean
// filter's time read and written: ~0.5-0.75 MB at the demonstrator's
// capacity of 28672 lanes, ~0.2 us at 3.35 TB/s.  It takes 11.6-15.0 us a
// frame with the L2 cache flushed on an H100 SXM, split by its ablations
// (experiments/filter_designs.py, PERF.md section 6): ~1.0 us the bare
// cooperative launch, ~1.2 us each grid barrier, 2.3-3.3 us the first pass
// (the cold lane loads and the atomics), 1.4-3.6 us each of the others
// (their scattered round trips; 3.6 the tile scan of ESL first_per_yt's
// 691 KB bitmap).  A design as thread-block clusters with the bitmap in
// distributed shared memory (experiments/filter_clusters.cu) measured
// slower for one frame: a cluster barrier costs ~0.8 us, one cluster a
// frame starves the passes of memory parallelism, and a frame cut over 8
// clusters loads every lane 8 times.
//
// What the design does about it: no sort and no fill.  One launch, four
// phases over the lanes (a grid-stride walk over F x n lanes), three grid
// barriers:
//   1. each valid positive lane takes its slot (JAX's index modes, below)
//      and does atomicMax of its priority into its frame's winner map:
//      n - i for first, i + 1 for last; the mean filter also atomicMax-es
//      i + 1 into its last-index map;
//   2. keep = the lane holds its slot's winner; the mean filter writes
//      t = floor((t_first + t_last) / 2) (int32, wrapping as torch's add);
//      each survivor sets its bit in a bitmap over the raw key + size
//      (raw keys of survivors lie in [-size, size)), and parks that bit's
//      index in its priority output;
//   3. the survivors clear their winner (and last-index) slots -- every
//      slot a lane touched holds a survivor, so the maps are zero again --
//      and each block scans one tile of a frame's bitmap words: for each
//      non-zero word, the popcount prefix within the tile and the word
//      itself go to `scan`, the word is cleared, the tile's total to
//      `tile_sum`;
//   4. each block scans the tile totals in shared memory, and each
//      survivor's priority is its rank among its frame's survivors by raw
//      key: the tiles before its own, its tile's words before its own, and
//      the bits below its own in its word (__popc).  A dropped lane's
//      priority is 0.
// The winner maps, the last-index maps and the bitmaps live in a scratch
// the wrapper keeps per device and stream (ops/filters.py); it is zero
// before each launch and the launch leaves it zero, so no frame pays a
// memset of its key map (11 MB at the ESL rig's first_per_yt).
//
// The priority contract: survivors have distinct raw keys (a key has one
// winner, and two raw keys that JAX's wrap sends to one slot share it), so
// ranking them by raw key orders every pair of survivors as the plain
// version's dense rank over all lanes does, below the capacity.  Only that
// order reaches kernel 1 (its packed key keeps the highest (prio + 1) *
// PACK + disp of a pixel's survivors).
//
// JAX's index modes, kept exactly (ops/filters.py _jax_index): size =
// n_keys + 1 slots (slot n_keys is real: a valid lane whose raw key is
// n_keys or -1 lands there); a negative key first counts from the end (k +
// size); a key still outside [0, size) is dropped by the scatter, and its
// lane, whose clamped gather can never read its own unique priority, is
// dropped.  Lanes outside the camera read the LUT at the clamped pixel, as
// rectify_events does (ops/disparity.py:46-58).
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
// tile totals a launch (F x tiles a frame), scanned in each block's shared
// memory in phase 4; the wrapper refuses groups of more frames
constexpr int MAX_TILES = 2048;

// the filter ids: their index in ops/filters.py FILTER_NAMES
constexpr int FIRST_PER_YT = 1;
constexpr int FIRST_PER_XY = 2;
constexpr int LAST_PER_XY = 3;
constexpr int MEAN_FIRST_LAST_PER_XY = 4;

struct Params {
  // lanes, (frames, n) rows
  const int32_t* __restrict__ x;
  const int32_t* __restrict__ y;
  const int32_t* __restrict__ p;
  const bool* __restrict__ valid;
  const void* t;  // int32 or float32; read by the mean filter only
  int t_float;
  int frames, n;
  int filter;
  int key_w;  // camera width (xy keys) or rectified width (yt keys)
  const int32_t* __restrict__ lut;  // first_per_yt: packed camera LUT (mapy<<16 | mapx)
  int lut_h, lut_w;
  int size;        // n_keys + 1 slots a frame
  int words;       // bitmap words a frame, ceil(2 * size / 32)
  int tiles;       // bitmap tiles a frame
  int tile_words;  // words a tile
  // scratch: win, last and bits zero at entry and exit
  int32_t* win;    // (frames, size)
  int32_t* last;   // (frames, size), the mean filter only
  uint32_t* bits;  // (frames, words)
  int2* scan;      // (frames, words): (prefix within the tile, word), non-zero words
  int32_t* tile_sum;  // (frames * tiles)
  // outputs, (frames, n)
  bool* keep_out;
  void* t_out;  // the mean filter only
  int32_t* prio_out;
};

// The lane's slot in its frame's maps and its raw key + size (the bitmap
// index), or live = false for a lane no filter keeps (invalid, not
// positive, or a key JAX's scatter drops).
struct Key {
  int slot;
  uint32_t bit;
  bool live;
};

__device__ __forceinline__ Key key_of(const Params& P, long g) {
  Key k{0, 0u, false};
  if (!P.valid[g] || P.p[g] != 1) return k;
  const int x = P.x[g];
  const int y = P.y[g];
  int kx = x;
  if (P.filter == FIRST_PER_YT) {
    const int yc = min(max(y, 0), P.lut_h - 1);
    const int xc = min(max(x, 0), P.lut_w - 1);
    const int mapx =
        static_cast<int16_t>(__ldg(P.lut + static_cast<long>(yc) * P.lut_w + xc) & 0xFFFF);
    kx = min(max(mapx, 0), P.key_w - 1);
  }
  // int32 arithmetic that wraps as torch's
  const int raw = static_cast<int>(static_cast<uint32_t>(y) * static_cast<uint32_t>(P.key_w) +
                                   static_cast<uint32_t>(kx));
  const long kn = raw < 0 ? static_cast<long>(raw) + P.size : raw;
  k.live = kn >= 0 && kn < P.size;
  k.slot = static_cast<int>(kn);
  k.bit = static_cast<uint32_t>(static_cast<long>(raw) + P.size);
  return k;
}

__device__ __forceinline__ int prio_of(const Params& P, int i) {
  return P.filter == LAST_PER_XY ? i + 1 : P.n - i;
}

__device__ __forceinline__ int t_as_int(const Params& P, long g) {
  // torch's .int(): truncation toward zero of a float time
  return P.t_float ? static_cast<int>(static_cast<const float*>(P.t)[g])
                   : static_cast<const int32_t*>(P.t)[g];
}

// Exclusive scan of one int a thread over the block; *total gets the sum.
// Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    sum += s;
  }
  __syncthreads();  // warp_sums is reused by the next call
  *total = sum;
  return before + incl - v;
}

__global__ void __launch_bounds__(THREADS) frame_dedup_filter_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  const long total = static_cast<long>(P.frames) * P.n;
  const long stride = static_cast<long>(gridDim.x) * THREADS;
  const long first = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  const bool mean = P.filter == MEAN_FIRST_LAST_PER_XY;

  // 1. the winners
  for (long g = first; g < total; g += stride) {
    const Key k = key_of(P, g);
    if (!k.live) continue;
    const int i = static_cast<int>(g % P.n);
    const long s = (g / P.n) * P.size + k.slot;
    atomicMax(P.win + s, prio_of(P, i));
    if (mean) atomicMax(P.last + s, i + 1);
  }
  grid.sync();

  // 2. the keep mask, the mean time, the survivors' bits
  for (long g = first; g < total; g += stride) {
    const Key k = key_of(P, g);
    const long f = g / P.n;
    const int i = static_cast<int>(g % P.n);
    const long s = f * P.size + k.slot;
    const bool keep = k.live && P.win[s] == prio_of(P, i);
    P.keep_out[g] = keep;
    if (mean) {
      if (keep) {
        const int j = P.last[s] - 1;  // >= 0: the lane itself is a candidate
        const int sum = static_cast<int>(static_cast<uint32_t>(t_as_int(P, g)) +
                                         static_cast<uint32_t>(t_as_int(P, f * P.n + j)));
        const int t_mean = sum >> 1;  // floor division by 2
        if (P.t_float) {
          static_cast<float*>(P.t_out)[g] = static_cast<float>(t_mean);
        } else {
          static_cast<int32_t*>(P.t_out)[g] = t_mean;
        }
      } else if (P.t_float) {
        static_cast<float*>(P.t_out)[g] = static_cast<const float*>(P.t)[g];
      } else {
        static_cast<int32_t*>(P.t_out)[g] = static_cast<const int32_t*>(P.t)[g];
      }
    }
    if (keep) atomicOr(P.bits + f * P.words + (k.bit >> 5), 1u << (k.bit & 31));
    P.prio_out[g] = keep ? static_cast<int>(k.bit) : -1;
  }
  grid.sync();

  // 3. the survivors clear the maps; the blocks scan the bitmap tiles
  for (long g = first; g < total; g += stride) {
    const int b = P.prio_out[g];
    if (b < 0) continue;
    const long slot = b < P.size ? b : b - P.size;
    const long s = (g / P.n) * P.size + slot;
    P.win[s] = 0;
    if (mean) P.last[s] = 0;
  }
  for (int tile = blockIdx.x; tile < P.frames * P.tiles; tile += gridDim.x) {
    const long row = static_cast<long>(tile / P.tiles) * P.words;
    const int w0 = (tile % P.tiles) * P.tile_words;
    const int w1 = min(P.words, w0 + P.tile_words);
    int carry = 0;
    for (int base = w0; base < w1; base += THREADS) {
      const int w = base + threadIdx.x;
      const uint32_t v = w < w1 ? P.bits[row + w] : 0u;
      int sum = 0;
      const int before = block_exclusive_scan(__popc(v), &sum);
      if (v != 0u) {
        P.scan[row + w] = make_int2(carry + before, static_cast<int>(v));
        P.bits[row + w] = 0u;
      }
      carry += sum;
    }
    if (threadIdx.x == 0) P.tile_sum[tile] = carry;
  }
  grid.sync();

  // 4. the tile totals' prefix (over the whole launch; a frame's own is the
  // difference from its first tile's), then each survivor's rank
  __shared__ int tile_prefix[MAX_TILES];
  const int n_tiles = P.frames * P.tiles;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += THREADS) {
    const int t = base + threadIdx.x;
    int sum = 0;
    const int before = block_exclusive_scan(t < n_tiles ? P.tile_sum[t] : 0, &sum);
    if (t < n_tiles) tile_prefix[t] = carry + before;
    carry += sum;
  }
  __syncthreads();
  for (long g = first; g < total; g += stride) {
    const int b = P.prio_out[g];
    if (b < 0) {
      P.prio_out[g] = 0;
      continue;
    }
    const long f = g / P.n;
    const int w = b >> 5;
    const int2 e = P.scan[f * P.words + w];
    const int t0 = static_cast<int>(f) * P.tiles;
    P.prio_out[g] = tile_prefix[t0 + w / P.tile_words] - tile_prefix[t0] + e.x +
                    __popc(static_cast<uint32_t>(e.y) & ((1u << (b & 31)) - 1u));
  }
}

// The co-resident grid of a cooperative launch on the current device,
// cached per device.
int resident_blocks(int* out) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, (const void*)frame_dedup_filter_kernel, THREADS, 0)) != cudaSuccess) {
      return e;
    }
    if (!coop) return cudaErrorNotSupported;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached[dev] = per_sm * sms;
  }
  *out = cached[dev];
  return cudaSuccess;
}

int launch(const int32_t* x, const int32_t* y, const int32_t* p, const bool* valid,
           const void* t, int t_float, int frames, int n, int filter, int key_w,
           int n_keys, const int32_t* lut, int lut_h, int lut_w, int32_t* zeroed,
           int32_t* work, bool* keep_out, void* t_out, int32_t* prio_out,
           cudaStream_t stream) {
  if (frames < 1 || frames > MAX_TILES || n < 1 || filter < FIRST_PER_YT ||
      filter > MEAN_FIRST_LAST_PER_XY || key_w < 1 || n_keys < 1 ||
      n_keys > (1 << 29) || (filter == FIRST_PER_YT && (!lut || lut_h < 1 || lut_w < 1)) ||
      (filter == MEAN_FIRST_LAST_PER_XY && !t_out)) {
    return cudaErrorInvalidValue;
  }
  int resident = 0;
  const int err = resident_blocks(&resident);
  if (err != cudaSuccess) return err;
  const long lanes = static_cast<long>(frames) * n;
  const int blocks = static_cast<int>(
      std::min(std::max(1L, (lanes + THREADS - 1) / THREADS), static_cast<long>(resident)));
  Params P{};
  P.x = x;
  P.y = y;
  P.p = p;
  P.valid = valid;
  P.t = t;
  P.t_float = t_float;
  P.frames = frames;
  P.n = n;
  P.filter = filter;
  P.key_w = key_w;
  P.lut = lut;
  P.lut_h = lut_h;
  P.lut_w = lut_w;
  P.size = n_keys + 1;
  P.words = (2 * P.size + 31) / 32;
  // about one tile a block; at most MAX_TILES in all
  P.tiles = std::max(1, std::min(blocks, MAX_TILES) / frames);
  P.tile_words = (P.words + P.tiles - 1) / P.tiles;
  const long map = static_cast<long>(frames) * P.size;
  P.win = zeroed;
  P.last = filter == MEAN_FIRST_LAST_PER_XY ? zeroed + map : nullptr;
  P.bits = reinterpret_cast<uint32_t*>(zeroed + (P.last ? 2 * map : map));
  P.scan = reinterpret_cast<int2*>(work);
  P.tile_sum = work + 2L * frames * P.words;
  P.keep_out = keep_out;
  P.t_out = t_out;
  P.prio_out = prio_out;
  void* args[] = {&P};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)frame_dedup_filter_kernel, dim3(blocks), dim3(THREADS), args, 0, stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return e != cudaSuccess ? e : last;
}

}  // namespace

// One frame of n lanes.  filter: the index in FILTER_NAMES (1-4); key_w:
// the camera width (the xy filters) or the rectified width (first_per_yt);
// n_keys: the key space (camera_width x camera_height, or camera_height x
// rect_width); lut: the packed camera LUT (first_per_yt only, else null).
// zeroed: the scratch the wrapper keeps zero, frames x (size, or 2 x size
// for the mean filter) + frames x words int32; work: 2 x frames x words +
// MAX_TILES int32 (ops/filters.py _scratch).  t_out: the mean filter only.
extern "C" int frame_dedup_filter(
    const int32_t* x, const int32_t* y, const int32_t* p, const bool* valid, const void* t,
    int t_float, int n, int filter, int key_w, int n_keys, const int32_t* lut, int lut_h,
    int lut_w, int32_t* zeroed, int32_t* work, bool* keep_out, void* t_out,
    int32_t* prio_out, cudaStream_t stream) {
  return launch(x, y, p, valid, t, t_float, 1, n, filter, key_w, n_keys, lut, lut_h, lut_w,
                zeroed, work, keep_out, t_out, prio_out, stream);
}

// F frames of n lanes, (F, n) rows, each frame with its own maps: frame f
// of the outputs equals the one-frame entry's on row f.
extern "C" int frame_dedup_filter_group(
    const int32_t* x, const int32_t* y, const int32_t* p, const bool* valid, const void* t,
    int t_float, int frames, int n, int filter, int key_w, int n_keys, const int32_t* lut,
    int lut_h, int lut_w, int32_t* zeroed, int32_t* work, bool* keep_out, void* t_out,
    int32_t* prio_out, cudaStream_t stream) {
  return launch(x, y, p, valid, t, t_float, frames, n, filter, key_w, n_keys, lut, lut_h,
                lut_w, zeroed, work, keep_out, t_out, prio_out, stream);
}
