// A design of kernel F (frame_dedup_filter: the four dedup frame filters'
// keep mask, mean time and scatter priority, of one frame or of F frames)
// as thread-block clusters, with no grid barrier (a launch of more than
// one part a frame is cooperative all the same, for the flags its parts
// wait on: below).  It is not the port's kernel: the port keeps its cooperative
// kernel (xmaps_tpu_torch/csrc/filters.cu), which this design does not
// beat for one frame, the entry the main path launches most.
// experiments/filter_designs.py builds it (at other THREADS and CLUSTER
// too, and stoppable), checks it bit-equal to the port's kernel and times
// the two in turns (PERF.md section 6, L2 flushed, on an H100 SXM:
// one frame slower in 14 of its 16 cells, by up to 3 us as the cooperative
// launch its flags need; a group of 12 6-21 % faster).
//
// Why clusters did not win: the port's kernel spends ~1.0 us on its
// cooperative launch, ~1.2 us on each of its three grid barriers and 7-10
// us on its four passes over the lanes (their scattered atomics and round
// trips).  An empty launch of these clusters measures the same ~1.0 us and
// a cluster barrier ~0.8 us, so the barriers save ~0.4 us.  One cluster a
// frame (16 SMs) measured 19-25 us a frame: its passes are starved of
// memory parallelism.  Cut into 8 parts, one cluster each, a frame
// measured 12.0-15.3 us (13.1-16.7 as a cooperative launch), but each part
// loads every lane and the parts pass their counts through flags in global
// memory.  A group of 12 gains, since a grid barrier there spans 5x the
// blocks.
//
// The design: clusters of CLUSTER blocks launched with cudaLaunchKernelEx,
// four cluster barriers.  A frame's n_keys + 1 slots are cut into `parts`
// (filter_designs.py cluster_plan: as many as fill ~128 blocks, 8 for one
// frame, 1 for a group of 8 or more), one cluster each; a cluster handles
// only the lanes whose slot lies in its part, and its survivors' bitmap
// over raw keys is its own, in its blocks' shared memory.  Each thread
// takes K lanes of its frame (lane i = k * CLUSTER * THREADS + its rank in
// the cluster), loads them and computes their keys once, keeps them in
// registers through the passes, and issues a pass's loads for all K before
// it uses one; first_per_yt reads the LUT only for the lanes whose camera
// row can reach its part.  A frame of more than LANES lanes walks the rest
// in steps of CLUSTER * THREADS, their keys recomputed in each pass.  The
// passes:
//   1. each block zeroes its slice of the part's bitmap; each of the
//      part's lanes (valid, positive, its slot by JAX's index modes,
//      below) does atomicMax of its priority into its frame's winner map
//      in global scratch: n - i for first, i + 1 for last; the mean filter
//      also atomicMax-es i + 1 into its last-index map;
//   2. keep = the lane holds its slot's winner; the mean filter writes
//      t = floor((t_first + t_last) / 2) (int32, wrapping as torch's add);
//      each survivor sets its bit -- its raw key's place in the part's
//      bitmap, the keys below 0 in a lower half, the others in an upper
//      half -- by atomicOr into the word of the block that owns it
//      (cluster.map_shared_rank); part 0 also writes the lanes no part
//      keeps (keep 0, priority 0);
//   3. the survivors clear their winner (and last-index) slots -- every
//      slot a lane touched holds a survivor, so the maps are zero again --
//      and each block scans its own words: each thread a run of `chunk`
//      words, one block scan of the runs' popcounts, each word's prefix
//      stored beside it; the block's count (and its lower half's) goes to
//      every block of the cluster;
//   4. with more than one part, each part publishes its lower and upper
//      half's survivor counts in a flag word tagged with the launch's
//      epoch and reads its frame's other parts'; each survivor's priority
//      is its rank among its frame's survivors by raw key: the survivors
//      of the lower halves before it (or of every lower half and of the
//      upper halves before it), of the blocks before its word's owner, the
//      owner's prefix for the word and the bits below its own (__popc).
//      A last barrier keeps every block resident until no block reads its
//      shared memory.
// Its limits, two of the reasons it is an experiment: with parts > 1 the
// clusters of a frame spin on each other's flags, so every cluster of the
// launch must be on the card at once.  A plain cluster launch does not
// guarantee that (work on another stream could leave a cluster unscheduled
// while the others spin), so such a launch is also cooperative: the card
// holds all of its clusters at once or refuses it.
// cudaOccupancyMaxActiveClusters, which reckons with an empty card, turns
// a launch that could never fit away first.  And the flags match by a
// 32-bit epoch: the caller must clear them before its epoch wraps
// (filter_designs.py does).
// The winner and last-index maps (1.2 MB a frame for the xy filters, 11 MB
// for first_per_yt at the ESL rig) live in a scratch the caller keeps zero
// before each launch; the launch leaves it zero.
//
// The shared-memory reckoning: a part of s slots has a bitmap of 2 x
// ceil(s / 32) words; a block holds ceil(words / CLUSTER) of them at 8 B
// (the word and its prefix) after SMALL_BYTES.  One part a frame: 9.6 KB
// for the xy filters (307,200 keys), 26.4 KB for first_per_yt at the
// demonstrator (844,800), 86.4 KB at the ESL rig (2,764,800); 8 parts: an
// eighth of that.  Past 227 KB a block (~7.4 M slots a part) the plan puts
// the bitmaps in global scratch: the same passes, the words atomicOr-ed in
// global memory, each block's prefixes written to a work area in pass 3,
// where the words are cleared.
//
// The priority contract and JAX's index modes are the port's kernel's
// (csrc/filters.cu's header).
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

// the launch plan; experiments/filter_designs.py cluster_plan mirrors these
constexpr int THREADS = 512;
constexpr int CLUSTER = 16;  // blocks a cluster (non-portable above 8)
constexpr int LANES = 32768;  // lanes a cluster holds in registers, K a thread
constexpr long MAX_SMEM = 232448;  // 227 KB: the most one sm_90 block may have
constexpr int MAX_FRAMES = 2048;  // ops/filters.py MAX_GROUP_FRAMES
constexpr int MAX_PARTS = 32;  // clusters a frame

// the filter ids: their index in ops/filters.py FILTER_NAMES
constexpr int FIRST_PER_YT = 1;
constexpr int FIRST_PER_XY = 2;
constexpr int LAST_PER_XY = 3;
constexpr int MEAN_FIRST_LAST_PER_XY = 4;

// The head of a block's dynamic shared memory; the bitmap words follow.
struct Small {
  int totals[32];     // each block's survivors, written by that block
  int base[32];       // the cluster's survivors in the blocks before each
  int counts[2];      // the block's survivors, lower and upper half
  int halves[2];      // the frame's survivors before the part's lower and upper half
  int warp_sums[16];  // block_exclusive_scan's
};
constexpr int SMALL_BYTES = sizeof(Small);

struct Params {
  // lanes, (frames, n) rows
  const int32_t* __restrict__ x;
  const int32_t* __restrict__ y;
  const int32_t* __restrict__ p;
  const bool* __restrict__ valid;
  const void* t;  // int32 or float32; read by the mean filter only
  int t_float;
  int n;
  int filter;
  int key_w;  // camera width (xy keys) or rectified width (yt keys)
  const int32_t* __restrict__ lut;  // first_per_yt: packed camera LUT (mapy<<16 | mapx)
  int lut_h, lut_w;
  int size;         // n_keys + 1 slots a frame
  int parts;        // clusters a frame; part q owns slots [q * part_slots, + part_slots)
  int part_slots;
  int half_bits;    // a local bitmap half, 32 x its words: raw key < 0, then >= 0
  int words;        // local bitmap words a cluster, two halves
  int block_words;  // words a block owns, ceil(words / CLUSTER)
  int chunk;        // words a thread scans in pass 3 (odd: no bank conflict)
  unsigned epoch;   // this launch's flag value, never 0
  // scratch: win, last and bits zero at entry and exit
  int32_t* win;    // (frames, size)
  int32_t* last;   // (frames, size), the mean filter only
  uint32_t* bits;  // (frames x parts, words) in global memory, or null: shared memory
  int2* scan;      // (frames x parts, words) work, global bitmap only: (prefix, word)
  // (frames x parts, 2): a part's lower and upper survivors, each tagged
  // with the epoch of the launch that wrote it (epoch << 32 | count)
  unsigned long long* flags;
  // outputs, (frames, n)
  bool* keep_out;
  void* t_out;  // the mean filter only
  int32_t* prio_out;
};

// The cluster barrier in two halves (cluster.sync() is both at once): a
// thread's work between them overlaps the barrier.  Every thread of the
// cluster calls each.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A lane held by a thread: mine = valid, positive, its key inside the map
// (JAX's index modes, below) and its slot in this cluster's part (after
// pass 2: and kept); dropped = no filter keeps it (part 0 writes its
// outputs); slot, its slot in the frame's maps; bit, its raw key's index
// in the cluster's local bitmap.
struct Key {
  int slot;
  int bit;
  bool mine;
  bool dropped;
};

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
__device__ __forceinline__ int block_exclusive_scan(int v, int* total, int* warp_sums) {
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

// One cluster: its part of a frame's slots, its local bitmap.  Each pass
// takes M lanes of a thread, i0 + m * step (m < M; those at or past n are
// not read), and issues the loads of all M before it uses one, so a thread
// waits for one round trip a pass, not M.
struct Part {
  const Params& P;
  cg::cluster_group cluster;
  Small* small;
  uint2* cells;  // this block's words: (word, prefix); shared bitmap only
  long row;      // the frame's first lane
  long map;      // the frame's first slot
  long wrow;     // the cluster's first bitmap word (global bitmap)
  int part;      // the cluster's part of its frame
  int lo, hi;    // its slots
  bool mean;

  // The keys: the lanes' fields loaded at once, then first_per_yt's LUT
  // entries at the clamped pixel -- only where the lane's row can reach a
  // slot of this part (a row inside the map lies in [y * key_w, + key_w)).
  template <int M>
  __device__ __forceinline__ void keys(int i0, int step, Key (&k)[M]) const {
    int x[M], y[M];
    bool ok[M], other[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      // a lane past the frame reads nothing (no thread reads a default
      // address: a thousand threads on one address wait in line)
      ok[m] = other[m] = false;
      x[m] = y[m] = 0;
      if (i0 + m * step < P.n) {
        const long g = row + i0 + m * step;
        ok[m] = P.valid[g] & (P.p[g] == 1);
        x[m] = P.x[g];
        y[m] = P.y[g];
      }
    }
    if (P.filter == FIRST_PER_YT) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const long r0 = static_cast<long>(y[m]) * P.key_w;
        other[m] = r0 >= 0 && r0 + P.key_w <= P.size && (r0 >= hi || r0 + P.key_w <= lo);
        if (ok[m] && !other[m]) {
          const int yc = min(max(y[m], 0), P.lut_h - 1);
          const int xc = min(max(x[m], 0), P.lut_w - 1);
          const int mapx = static_cast<int16_t>(
              __ldg(P.lut + static_cast<long>(yc) * P.lut_w + xc) & 0xFFFF);
          x[m] = min(max(mapx, 0), P.key_w - 1);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      // int32 arithmetic that wraps as torch's
      const int raw = static_cast<int>(static_cast<uint32_t>(y[m]) *
                                           static_cast<uint32_t>(P.key_w) +
                                       static_cast<uint32_t>(x[m]));
      const long kn = raw < 0 ? static_cast<long>(raw) + P.size : raw;
      const bool live = ok[m] && (other[m] || (kn >= 0 && kn < P.size));
      k[m].mine = live && !other[m] && kn >= lo && kn < hi;
      k[m].dropped = !live;
      k[m].slot = k[m].mine ? static_cast<int>(kn) : 0;
      k[m].bit = k[m].mine ? (raw < 0 ? 0 : P.half_bits) + static_cast<int>(kn) - lo : 0;
    }
  }

  // 1. this part's lanes' priorities into their slots' winners
  template <int M>
  __device__ __forceinline__ void claim(const Key (&k)[M], int i0, int step) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (!k[m].mine) continue;
      const int i = i0 + m * step;
      atomicMax(P.win + map + k[m].slot, prio_of(P, i));
      if (mean) atomicMax(P.last + map + k[m].slot, i + 1);
    }
  }

  // The word of the local bitmap that holds bit b.
  __device__ __forceinline__ uint32_t* word_of(int b) {
    const int w = b >> 5;
    if (P.bits) return P.bits + wrow + w;
    const int owner = w / P.block_words;
    return &cluster.map_shared_rank(cells + (w - owner * P.block_words), owner)->x;
  }

  // 2. keep and the mean time out for this part's lanes (and part 0's for
  // the dropped lanes, with their priority 0), the survivors' bits set and
  // counted into *counts (lower, upper half); k[m].mine becomes kept.  A
  // lane reads only what it needs: slot 0 is no lane's default
  template <int M>
  __device__ __forceinline__ void keep(Key (&k)[M], int i0, int step, int* counts) {
    // the winner maps by L2: other blocks' atomics landed there
    int win[M], t_own[M], j[M], t_last[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      win[m] = j[m] = t_own[m] = t_last[m] = 0;
      if (k[m].mine) {
        win[m] = __ldcg(P.win + map + k[m].slot);
        if (mean) j[m] = __ldcg(P.last + map + k[m].slot) - 1;  // >= 0: the lane claimed it
      }
      const int i = i0 + m * step;
      if (mean && i < P.n && (k[m].mine || (k[m].dropped && part == 0))) {
        t_own[m] = t_as_int(P, row + i);
      }
    }
    if (mean) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (k[m].mine) t_last[m] = t_as_int(P, row + j[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = i0 + m * step;
      const bool writes = k[m].mine || (k[m].dropped && part == 0);
      if (i >= P.n || !writes) continue;
      const long g = row + i;
      const bool kept = k[m].mine && win[m] == prio_of(P, i);
      k[m].mine = kept;
      P.keep_out[g] = kept;
      if (mean) {
        const int t_mean = static_cast<int>(static_cast<uint32_t>(t_own[m]) +
                                            static_cast<uint32_t>(t_last[m])) >>
                           1;  // floor division by 2, the sum wrapping as torch's
        if (P.t_float) {
          const float* t = static_cast<const float*>(P.t);
          static_cast<float*>(P.t_out)[g] = kept ? static_cast<float>(t_mean) : t[g];
        } else {
          const int32_t* t = static_cast<const int32_t*>(P.t);
          static_cast<int32_t*>(P.t_out)[g] = kept ? t_mean : t[g];
        }
      }
      if (kept) {
        atomicOr(word_of(k[m].bit), 1u << (k[m].bit & 31));
        ++counts[k[m].bit >= P.half_bits];
      } else {
        P.prio_out[g] = 0;
      }
    }
  }

  // 3. the survivors clear their slots
  template <int M>
  __device__ __forceinline__ void clear(const Key (&k)[M]) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (!k[m].mine) continue;
      P.win[map + k[m].slot] = 0;
      if (mean) P.last[map + k[m].slot] = 0;
    }
  }

  // 4. the survivors' ranks by raw key among their frame's survivors, into
  // r (every read of another block's shared memory done on return)
  template <int M>
  __device__ __forceinline__ void ranks(const Key (&k)[M], int (&r)[M]) {
    uint32_t word[M], prefix[M];
    int owner[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int w = k[m].bit >> 5;
      owner[m] = w / P.block_words;
      word[m] = prefix[m] = 0u;
      if (!k[m].mine) continue;
      if (P.bits) {
        const int2 e = __ldcg(P.scan + wrow + w);
        prefix[m] = static_cast<uint32_t>(e.x);
        word[m] = static_cast<uint32_t>(e.y);
      } else {
        const uint2 c =
            *cluster.map_shared_rank(cells + (w - owner[m] * P.block_words), owner[m]);
        word[m] = c.x;
        prefix[m] = c.y;
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      r[m] = small->halves[k[m].bit >= P.half_bits] + small->base[owner[m]] +
             static_cast<int>(prefix[m]) + __popc(word[m] & ((1u << (k[m].bit & 31)) - 1u));
    }
  }

  // the survivors' ranks out
  template <int M>
  __device__ __forceinline__ void store(const Key (&k)[M], const int (&r)[M], int i0,
                                        int step) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = i0 + m * step;
      if (i < P.n && k[m].mine) P.prio_out[row + i] = r[m];
    }
  }

  // a lane past the held ones in passes 3 and 4: its key again, kept as
  // pass 2 wrote it
  __device__ __forceinline__ void again(int i, Key (&k)[1]) const {
    keys(i, 0, k);
    if (k[0].mine) k[0].mine = P.keep_out[row + i];
  }
};

__global__ void __launch_bounds__(THREADS) frame_dedup_filter_kernel(Params P) {
  constexpr int STRIDE = CLUSTER * THREADS;
  constexpr int K = LANES / STRIDE;
  static_assert(K * STRIDE == LANES && CLUSTER <= 32, "the lanes a cluster holds");
  extern __shared__ __align__(16) unsigned char smem[];
  Small* small = reinterpret_cast<Small*>(smem);
  uint2* cells = reinterpret_cast<uint2*>(smem + SMALL_BYTES);
  cg::cluster_group cluster = cg::this_cluster();
  const int me = static_cast<int>(cluster.block_rank());
  const long q = blockIdx.x / CLUSTER;  // the cluster: frame q / parts, part q % parts
  const long f = q / P.parts;
  const int part = static_cast<int>(q % P.parts);
  const int lo = part * P.part_slots;
  Part F{P, cluster, small, cells, f * P.n, f * P.size, q * P.words, part, lo,
                 min(lo + P.part_slots, P.size), P.filter == MEAN_FIRST_LAST_PER_XY};
  const int first = me * THREADS + static_cast<int>(threadIdx.x);
  // this block's words of the local bitmap: [w0, w0 + nw)
  const int w0 = me * P.block_words;
  const int nw = max(0, min(P.words - w0, P.block_words));

  // 1. zero this block's words and counts; the lanes' keys, held; the
  // winners
  if (!P.bits) {
    for (int j = threadIdx.x; j < nw; j += THREADS) cells[j] = make_uint2(0u, 0u);
  }
  if (threadIdx.x < 2) small->counts[threadIdx.x] = 0;
  Key held[K];
  F.keys(first, STRIDE, held);
  F.claim(held, first, STRIDE);
  for (int i = first + LANES; i < P.n; i += STRIDE) {
    Key k[1];
    F.keys(i, 0, k);
    F.claim(k, i, 0);
  }
  cluster.sync();

  // 2. keep, the mean time, the survivors' bits; with more than one part,
  // the survivors counted into the block's counts (a warp's sum at once)
  int counts[2] = {0, 0};
  F.keep(held, first, STRIDE, counts);
  for (int i = first + LANES; i < P.n; i += STRIDE) {
    Key k[1];
    F.keys(i, 0, k);
    F.keep(k, i, 0, counts);
  }
  if (P.parts > 1) {
    const int low = __reduce_add_sync(0xffffffffu, counts[0]);
    const int up = __reduce_add_sync(0xffffffffu, counts[1]);
    if ((threadIdx.x & 31) == 0 && (low | up)) {
      atomicAdd(small->counts, low);
      atomicAdd(small->counts + 1, up);
    }
  }
  cluster.sync();

  // 3. the part's counts, its blocks' summed by block 0, out to its
  // frame's other parts (each a 64-bit word of epoch and count, valid on
  // its own); each block scans its words
  if (P.parts > 1 && me == 0 && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int* c = cluster.map_shared_rank(small->counts, lane < CLUSTER ? lane : 0);
    const int low = __reduce_add_sync(0xffffffffu, lane < CLUSTER ? c[0] : 0);
    const int up = __reduce_add_sync(0xffffffffu, lane < CLUSTER ? c[1] : 0);
    if (lane < 2) {
      atomicExch(P.flags + 2 * q + lane, (static_cast<unsigned long long>(P.epoch) << 32) |
                                             static_cast<unsigned>(lane ? up : low));
    }
  }
  const int j0 = min(nw, static_cast<int>(threadIdx.x) * P.chunk);
  const int j1 = min(nw, j0 + P.chunk);
  uint32_t* gbits = P.bits ? P.bits + F.wrow + w0 : nullptr;
  int run = 0;
  for (int j = j0; j < j1; ++j) run += __popc(gbits ? __ldcg(gbits + j) : cells[j].x);
  int total = 0;
  int before = block_exclusive_scan(run, &total, small->warp_sums);
  for (int j = j0; j < j1; ++j) {
    if (gbits) {
      const uint32_t v = __ldcg(gbits + j);
      if (v != 0u) {
        P.scan[F.wrow + w0 + j] = make_int2(before, static_cast<int>(v));
        gbits[j] = 0u;
        before += __popc(v);
      }
    } else {
      cells[j].y = static_cast<uint32_t>(before);
      before += __popc(cells[j].x);
    }
  }
  if (threadIdx.x < CLUSTER) *cluster.map_shared_rank(small->totals + me, threadIdx.x) = total;
  // the survivors' slots cleared behind the barrier
  cluster_arrive();
  F.clear(held);
  for (int i = first + LANES; i < P.n; i += STRIDE) {
    Key k[1];
    F.again(i, k);
    F.clear(k);
  }
  cluster_wait();

  // 4. the blocks' bases; the frame's survivors before this part's lower
  // half (the parts before it) and before its upper half (every part's
  // lower half, the parts before it); each survivor's rank
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int v = lane < CLUSTER ? small->totals[lane] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    small->base[lane] = incl - v;
    int l = 0, u = 0;
    if (P.parts > 1 && lane < P.parts) {
      volatile unsigned long long* w = P.flags + 2 * (f * P.parts + lane);
      unsigned long long a, b;
      do {
        a = w[0];
        b = w[1];
      } while ((a >> 32) != P.epoch || (b >> 32) != P.epoch);
      l = static_cast<int>(a & 0xffffffffu);
      u = static_cast<int>(b & 0xffffffffu);
    }
    const int lows_all = __reduce_add_sync(0xffffffffu, l);
    const int lows_before = __reduce_add_sync(0xffffffffu, lane < part ? l : 0);
    const int uppers_before = __reduce_add_sync(0xffffffffu, lane < part ? u : 0);
    const int low_own = __shfl_sync(0xffffffffu, l, part & 31);
    if (lane == 0) {
      small->halves[0] = lows_before;
      small->halves[1] = lows_all - low_own + uppers_before;
    }
  }
  __syncthreads();
  int r[K];
  F.ranks(held, r);
  for (int i = first + LANES; i < P.n; i += STRIDE) {
    Key k[1];
    int rk[1];
    F.again(i, k);
    F.ranks(k, rk);
    F.store(k, rk, i, 0);
  }
  // no block leaves while another may still read its shared memory; the
  // held ranks stored behind the barrier
  cluster_arrive();
  F.store(held, r, first, STRIDE);
  cluster_wait();
}

// The kernel's attributes set (dynamic shared memory up to MAX_SMEM, the
// non-portable cluster size), once a device.
cudaError_t prepare() {
  static bool ready[64] = {};
  const void* kernel = reinterpret_cast<const void*>(frame_dedup_filter_kernel);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(MAX_SMEM))) != cudaSuccess ||
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess) {
    return e;
  }
  ready[dev] = true;
  return cudaSuccess;
}

// The clusters of CLUSTER blocks with smem bytes each that the current
// device holds at once, cached per device and size.
cudaError_t resident_clusters(long smem, int* out) {
  struct Entry {
    int dev;
    long smem;
    int clusters;
  };
  static Entry cache[64] = {};
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int c = 0; c < used; ++c) {
    if (cache[c].dev == dev && cache[c].smem == smem) {
      *out = cache[c].clusters;
      return cudaSuccess;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(frame_dedup_filter_kernel), &cfg);
  if (e != cudaSuccess) return e;
  if (used < 64) cache[used++] = Entry{dev, smem, clusters};
  *out = clusters;
  return cudaSuccess;
}

// Launch kernel F over `frames` frames, `parts` clusters of CLUSTER blocks
// each (filter_designs.py cluster_plan).  global_bits: the bitmaps in global scratch,
// else in the clusters' shared memory, which must then hold them.  With
// parts > 1 the clusters of a frame wait for each other's totals, so all
// of the launch's clusters must be resident at once: the launch is then
// cooperative as well, and one the card cannot hold is an error.
int launch_clusters(const int32_t* x, const int32_t* y, const int32_t* p, const bool* valid,
                    const void* t, int t_float, int frames, int n, int filter, int key_w,
                    int n_keys, const int32_t* lut, int lut_h, int lut_w, int parts,
                    int global_bits, unsigned epoch, int32_t* flags, int32_t* zeroed,
                    int32_t* work, bool* keep_out, void* t_out, int32_t* prio_out,
                    cudaStream_t stream) {
  if (frames < 1 || frames > MAX_FRAMES || n < 1 ||
      filter < FIRST_PER_YT || filter > MEAN_FIRST_LAST_PER_XY || key_w < 1 || n_keys < 1 ||
      n_keys > (1 << 29) || (filter == FIRST_PER_YT && (!lut || lut_h < 1 || lut_w < 1)) ||
      (filter == MEAN_FIRST_LAST_PER_XY && !t_out) || (global_bits && !work) || parts < 1 ||
      parts > MAX_PARTS || (parts > 1 && (!flags || epoch == 0u))) {
    return cudaErrorInvalidValue;
  }
  Params P{};
  P.x = x;
  P.y = y;
  P.p = p;
  P.valid = valid;
  P.t = t;
  P.t_float = t_float;
  P.n = n;
  P.filter = filter;
  P.key_w = key_w;
  P.lut = lut;
  P.lut_h = lut_h;
  P.lut_w = lut_w;
  P.size = n_keys + 1;
  P.parts = parts;
  P.part_slots = (P.size + parts - 1) / parts;
  P.half_bits = 32 * ((P.part_slots + 31) / 32);
  P.words = 2 * (P.half_bits / 32);
  P.block_words = (P.words + CLUSTER - 1) / CLUSTER;
  P.chunk = ((P.block_words + THREADS - 1) / THREADS) | 1;
  P.epoch = epoch;
  const long smem = SMALL_BYTES + (global_bits ? 0L : 8L * P.block_words);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const long map = static_cast<long>(frames) * P.size;
  P.win = zeroed;
  P.last = filter == MEAN_FIRST_LAST_PER_XY ? zeroed + map : nullptr;
  P.bits = global_bits ? reinterpret_cast<uint32_t*>(zeroed + (P.last ? 2 * map : map))
                       : nullptr;
  P.scan = global_bits ? reinterpret_cast<int2*>(work) : nullptr;
  P.flags = reinterpret_cast<unsigned long long*>(flags);
  P.keep_out = keep_out;
  P.t_out = t_out;
  P.prio_out = prio_out;
  cudaError_t e = prepare();
  int resident = 0;
  if (e == cudaSuccess) e = resident_clusters(smem, &resident);
  if (e == cudaSuccess && resident < (parts > 1 ? frames * parts : 1)) {
    e = cudaErrorLaunchOutOfResources;
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(frames * parts * CLUSTER));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = parts > 1 ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, frame_dedup_filter_kernel, P);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return e != cudaSuccess ? e : last;
}

}  // namespace
