// Kernel S: tile_store_last -- last-write-wins stores of N (row, col, value)
// events into a zeroed (H, W) uint32 tile.
//
// Replaces the TPU kernel kernel_rowcol (eval/bench_store_loop.py:52-83), the
// scatter-store micro-benchmark: zero the tile, then out[rows[j], cols[j]] =
// vals[j] for j = 0..N-1 in order.  Its (8, 128) read-modify-write and its
// unroll knob exist only because Mosaic has no scalar store into VMEM; they
// are not carried over.  Events outside the tile are dropped.
//
// What bounds it on the H100: not bytes (12 B an event in, 4 B a cell out:
// 0.64 MB at the benchmark's shape, 0.19 us at 3.35 TB/s) but the launch,
// the scan of the events and the scattered atomics.  The whole tile (64 x
// 1152 x 4 B = 288 KiB) does not fit the 227 KB of shared memory one block
// may have.
//
// What the design does about it: one thread-block cluster holds the tile in
// distributed shared memory.  Each of its 16 blocks (a non-portable
// cluster: on the H100 it measured faster than 8, the portable maximum;
// PERF.md section 6) owns a band of ceil(rows / 16) rows (4 x 1152 x 4 B =
// 18 KiB at the benchmark's shape).  A pass: every block zeroes its band;
// cluster barrier; every block reads its own 1/16 of the events once and
// does an atomicMax of j + 1 into the owning block's shared memory
// (cluster.map_shared_rank): the highest event index wins whatever order the
// threads run in, which is last write wins (the idea of kernel 1's packed
// key); cluster barrier; every block writes its band, vals[winner - 1] or 0,
// with 16-byte stores where the band is aligned.  A tile larger than a cluster's shared memory runs
// several clusters, each owning a slab of rows and reading every event once;
// a row wider than one block's shared memory is cut into column chunks.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 1024;
constexpr int CLUSTER = 16;  // blocks of a cluster (non-portable above 8)
constexpr long MAX_SMEM = 232448;  // 227 KB: the most one sm_90 block may have
constexpr int NO_OPT_IN_SMEM = 48 * 1024;

__global__ void __launch_bounds__(THREADS)
    tile_store_last_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                           const uint32_t* __restrict__ vals, int n, int h, int w,
                           int band_rows, int band_cols, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t win[];
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int slab_r0 = (blockIdx.x / blocks) * blocks * band_rows;
  const int slab_rows = min(blocks * band_rows, h - slab_r0);
  const int r0 = slab_r0 + rank * band_rows;  // this block's band
  const int br = max(0, min(band_rows, h - r0));
  const int c0 = blockIdx.y * band_cols;
  const int bc = min(band_cols, w - c0);
  const int cells = br * bc;
  // 1. zero the band
  uint4* win4 = reinterpret_cast<uint4*>(win);
  for (int k = threadIdx.x; k < cells / 4; k += blockDim.x) win4[k] = make_uint4(0, 0, 0, 0);
  for (int k = 4 * (cells / 4) + threadIdx.x; k < cells; k += blockDim.x) win[k] = 0u;
  // 2. no remote access before every block of the cluster runs and is zeroed
  cluster.sync();
  // 3. this block's share of the events, each read once by the cluster
  for (int j = rank * blockDim.x + threadIdx.x; j < n; j += blocks * blockDim.x) {
    const int r = __ldg(rows + j) - slab_r0;
    const int c = __ldg(cols + j) - c0;
    if (r >= 0 && r < slab_rows && c >= 0 && c < bc) {
      const int owner = r / band_rows;
      uint32_t* dst = cluster.map_shared_rank(win, owner);
      atomicMax(dst + (r - owner * band_rows) * bc + c, static_cast<uint32_t>(j) + 1u);
    }
  }
  // 4. every store of the cluster has landed
  cluster.sync();
  // 5. the band out: contiguous in the tile where it spans the whole width
  uint32_t* o = out + static_cast<long>(r0) * w + c0;
  if (bc == w && (reinterpret_cast<uintptr_t>(o) & 15u) == 0) {
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int k = threadIdx.x; k < cells / 4; k += blockDim.x) {
      const uint4 s = win4[k];
      o4[k] = make_uint4(s.x ? __ldg(vals + s.x - 1) : 0u, s.y ? __ldg(vals + s.y - 1) : 0u,
                         s.z ? __ldg(vals + s.z - 1) : 0u, s.w ? __ldg(vals + s.w - 1) : 0u);
    }
    for (int k = 4 * (cells / 4) + threadIdx.x; k < cells; k += blockDim.x) {
      o[k] = win[k] ? __ldg(vals + win[k] - 1) : 0u;
    }
  } else {
    for (int k = threadIdx.x; k < cells; k += blockDim.x) {
      const int r = k / bc;
      o[static_cast<long>(r) * w + (k - r * bc)] = win[k] ? __ldg(vals + win[k] - 1) : 0u;
    }
  }
}

}  // namespace

extern "C" int tile_store_last(const int32_t* rows, const int32_t* cols,
                               const int32_t* vals, int n, int h, int w,
                               int32_t* out, cudaStream_t stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  // the plan: column chunks a block's shared memory holds one row of, then
  // as few slabs of CLUSTER bands as the shared memory allows
  const int band_cols = static_cast<int>(std::min<long>(w, MAX_SMEM / 4));
  const int chunks = (w + band_cols - 1) / band_cols;
  const long rows_max = MAX_SMEM / (4L * band_cols);
  const long slabs = (h + CLUSTER * rows_max - 1) / (CLUSTER * rows_max);
  const int band_rows = static_cast<int>((h + CLUSTER * slabs - 1) / (CLUSTER * slabs));
  const size_t smem = sizeof(uint32_t) * band_rows * band_cols;
  cudaError_t e = cudaSuccess;
  if (smem > NO_OPT_IN_SMEM) {
    e = cudaFuncSetAttribute(tile_store_last_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(tile_store_last_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(CLUSTER * slabs), static_cast<unsigned>(chunks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tile_store_last_kernel, rows, cols,
                         reinterpret_cast<const uint32_t*>(vals), n, h, w, band_rows,
                         band_cols, reinterpret_cast<uint32_t*>(out));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
