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
// 0.64 MB at the benchmark's shape, 0.19 us at 3.35 TB/s) but the launch
// and the scan: the whole tile (64 x 1152 x 4 B = 288 KiB) does not fit the
// 227 KB of shared memory one block may have, so every block reads all N
// events (from L2 after the first block) and keeps those of its band.
//
// What the design does about it: the tile is split into bands of BAND_ROWS
// rows and at most BAND_COLS columns (8 x 1152 x 4 B = 36 KiB at the
// benchmark's shape, under the 48 KB that needs no opt-in), one block a
// band.  A block zeroes its band in shared memory, scans the events with
// all its threads, and does a shared-memory atomicMax of j + 1 into the
// event's cell: the highest event index wins whatever order the threads
// run in, which is last-write-wins (the idea of kernel 1's packed key; a
// 64-bit (j, v) key would be the alternative, since v takes 30 bits and j
// 15).  Then it writes vals[winner - 1], or 0, with coalesced stores.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BAND_ROWS = 8;
constexpr int BAND_COLS = 1536;  // 8 x 1536 x 4 B = 48 KiB at most
constexpr int THREADS = 1024;

__global__ void tile_store_last_kernel(const int32_t* __restrict__ rows,
                                       const int32_t* __restrict__ cols,
                                       const uint32_t* __restrict__ vals,
                                       int n, int h, int w,
                                       uint32_t* __restrict__ out) {
  extern __shared__ uint32_t win[];
  const int r0 = blockIdx.y * BAND_ROWS;
  const int c0 = blockIdx.x * BAND_COLS;
  const int br = min(BAND_ROWS, h - r0);
  const int bc = min(BAND_COLS, w - c0);
  const int cells = br * bc;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) win[k] = 0u;
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int r = __ldg(rows + j) - r0;
    const int c = __ldg(cols + j) - c0;
    if (r >= 0 && r < br && c >= 0 && c < bc) {
      atomicMax(win + r * bc + c, static_cast<uint32_t>(j) + 1u);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const uint32_t j1 = win[k];
    const int r = k / bc;
    const int c = k - r * bc;
    out[static_cast<long>(r0 + r) * w + c0 + c] = j1 ? __ldg(vals + j1 - 1) : 0u;
  }
}

}  // namespace

extern "C" int tile_store_last(const int32_t* rows, const int32_t* cols,
                               const int32_t* vals, int n, int h, int w,
                               int32_t* out, cudaStream_t stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((w + BAND_COLS - 1) / BAND_COLS,
                  (h + BAND_ROWS - 1) / BAND_ROWS);
  const int band_w = w < BAND_COLS ? w : BAND_COLS;
  const size_t smem = sizeof(uint32_t) * BAND_ROWS * band_w;
  tile_store_last_kernel<<<grid, THREADS, smem, stream>>>(
      rows, cols, reinterpret_cast<const uint32_t*>(vals), n, h, w,
      reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
