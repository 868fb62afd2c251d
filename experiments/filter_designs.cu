// Designs of kernel F (frame_dedup_filter), kept to time them against the
// port's (xmaps_tpu_torch/csrc/filters.cu).
// experiments/filter_designs.py builds this file with -I on a directory
// that holds filters_port.cu (the port's csrc/filters.cu with its kernel in
// namespace port and its C entries cut off) and filter_clusters_build.cu
// (the cluster design, experiments/filter_clusters.cu, at a THREADS and
// CLUSTER of each build, made stoppable: kernel_f_stop; a name of its own,
// so that the include does not find the unpatched file beside this one),
// checks every design that
// computes the whole function equal to the port's kernel and to the plain
// version, and times them in turns.  Every entry takes (frames, n) lanes,
// as the group entry does; frames = 1 is the one-frame entry.
//
//   design_port               the port's kernel F: one cooperative launch
//                             of the resident grid, four passes, three grid
//                             barriers, the survivor bitmap in global
//                             scratch, scanned in tiles.
//   design_port_ablation      the port's kernel with parts taken away, on
//                             its grid and scratch: 0 an empty cooperative
//                             launch, 1 the same with three grid.sync(), 2
//                             pass 1 alone, 3 passes 1-2 (one barrier), 4
//                             passes 1-3 (two barriers).  Their outputs are
//                             not the function's, and the scratch they leave
//                             is not zero: give them a scratch of their own.
//   design_cluster            the cluster design, any number of parts
//                             (clusters) a frame, its bitmap in shared or
//                             global memory.
//   design_cluster_ablation   the cluster design's launch, its clusters and
//                             shared memory: 0 empty, 1 with four
//                             cluster.sync().
#include "filter_clusters_build.cu"
#include "filters_port.cu"

namespace port {

// -- the ablations of the port's kernel ---------------------------------------

__global__ void __launch_bounds__(THREADS) ablation_kernel(Params P, int mode) {
  cg::grid_group grid = cg::this_grid();
  if (mode == 0) return;
  if (mode == 1) {
    grid.sync();
    grid.sync();
    grid.sync();
    return;
  }
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
  if (mode == 2) return;
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
        const int j = P.last[s] - 1;
        const int sum = static_cast<int>(static_cast<uint32_t>(t_as_int(P, g)) +
                                         static_cast<uint32_t>(t_as_int(P, f * P.n + j)));
        const int t_mean = sum >> 1;
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
  if (mode == 3) return;
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
}

// the port's launch with the ablation kernel in place of its own
int launch_ablation(int mode, const int32_t* x, const int32_t* y, const int32_t* p,
                    const bool* valid, const void* t, int t_float, int frames, int n,
                    int filter, int key_w, int n_keys, const int32_t* lut, int lut_h,
                    int lut_w, int32_t* zeroed, int32_t* work, bool* keep_out, void* t_out,
                    int32_t* prio_out, cudaStream_t stream) {
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
  void* args[] = {&P, &mode};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)ablation_kernel, dim3(blocks), dim3(THREADS), args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace port

namespace {

__global__ void __launch_bounds__(THREADS) cluster_ablation_kernel(int mode) {
  if (mode == 0) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  cluster.sync();
  cluster.sync();
  cluster.sync();
}

int launch_cluster_ablation(int mode, int clusters, int smem, cudaStream_t stream) {
  const void* k = reinterpret_cast<const void*>(cluster_ablation_kernel);
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(MAX_SMEM));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * CLUSTER));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cluster_ablation_kernel, mode);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace

#define LANE_ARGS                                                                         \
  const int32_t *x, const int32_t *y, const int32_t *p, const bool *valid, const void *t, \
      int t_float, int frames, int n, int filter, int key_w, int n_keys, const int32_t *lut, \
      int lut_h, int lut_w
#define LANE_NAMES x, y, p, valid, t, t_float, frames, n, filter, key_w, n_keys, lut, lut_h, lut_w

// zeroed: frames x (size, 2 x size for the mean filter, + words) int32 kept
// zero; work: 2 x frames x words + 2048 int32
extern "C" int design_port(LANE_ARGS, int32_t* zeroed, int32_t* work, bool* keep_out,
                           void* t_out, int32_t* prio_out, cudaStream_t stream) {
  return port::launch(LANE_NAMES, zeroed, work, keep_out, t_out, prio_out, stream);
}

extern "C" int design_port_ablation(int mode, LANE_ARGS, int32_t* zeroed, int32_t* work,
                                    bool* keep_out, void* t_out, int32_t* prio_out,
                                    cudaStream_t stream) {
  return port::launch_ablation(mode, LANE_NAMES, zeroed, work, keep_out, t_out, prio_out,
                               stream);
}

// the cluster design (this build's THREADS and CLUSTER); parts: clusters a
// frame; zeroed, work and flags as filter_designs.py cluster_plan lays
// them out; epoch: never 0, a new one every launch on the flags
extern "C" int design_cluster(LANE_ARGS, int parts, int global_bits, unsigned epoch,
                              int32_t* flags, int32_t* zeroed, int32_t* work, bool* keep_out,
                              void* t_out, int32_t* prio_out, cudaStream_t stream) {
  return launch_clusters(LANE_NAMES, parts, global_bits, epoch, flags, zeroed, work, keep_out,
                         t_out, prio_out, stream);
}

// where the cluster design returns (experiments/filter_designs.py STOPS; -1:
// nowhere); the next launch reads it
extern "C" int design_set_stop(int stop) {
  return static_cast<int>(cudaMemcpyToSymbol(kernel_f_stop, &stop, sizeof(int)));
}

// clusters: frames x parts
extern "C" int design_cluster_ablation(int mode, int clusters, int smem, cudaStream_t stream) {
  return launch_cluster_ablation(mode, clusters, smem, stream);
}
