// Kernel D: esl_denoise -- ESL's denoise of the refined depth (the reference
// eval/compute_depth_esl.py:242 cv2.bilateralFilter(depth, 5, 3, 3), then
// eval/esl_utilities.py:194-224's split-Bregman TV-L2 denoise) of every
// (H, W) slice of an (F, H, W) group of scans, in 1 + niter launches.
//
// What it computes: the plain versions of ops/esl_denoise.py,
// bilateral_filter then tv_denoise_split_bregman.  The bilateral (window
// half-width r, edges replicated) weighs each tap q of pixel c by
//     exp(-(q - c)^2 * inv2sc - (dy^2 + dx^2) * inv2ss)
// and divides the weighted sum by the weights' sum.  The TV denoise runs
// niter outer iterations of split Bregman on y (the bilateral's output):
//     d = shrink(grad u + b, thresh),  b = (b + grad u) - d   (0 at first)
//     rhs = mu y - lam div(d - b)
//     niter_inner Jacobi sweeps  u = (rhs + lam neigh(u)) / diag
// with the shifts reading 0 outside the image.  The plain version, whose
// ~5,600 launches a group of 12 scans this kernel replaces, is those two
// functions.
//
// It replaces no TPU kernel: the JAX package's denoise
// (xmaps_tpu/utils/denoise.py) is plain XLA with no Pallas kernel.  It was
// added because the port's plain version, about 5,566 PyTorch elementwise
// launches a group of 12 scans, left the esl-gt-scan-groups benchmark cell
// bound by the host's issue of those launches (~70 % of a call).
//
// What bounds it on the H100: FP32 instruction issue inside a launch, and
// the state's traffic between launches.  A pixel needs ~1,760 FP32 adds,
// multiplies and divisions (the bilateral 8 a tap, the TV 6 a sweep and 19
// an outer iteration), ~0.19 ms for 12 ESL scans (3.69 M px) at 132 x 128
// lanes x 1.98 GHz; the input and the output alone are 8 B a pixel.  Between
// the launches the state goes through device memory: a call moves 532 B a
// pixel (the bilateral 8; the TV's first launch reads y and writes u, 8; the
// second reads y, u and writes u, bx, by, 20; each of the next 17 reads y, u,
// bx, by and writes u, bx, by, 28; the last reads 16 and writes u, 4), 1.96
// GB for 12 ESL scans, 0.59 ms at 3.35 TB/s.
//
// What the design does about it: one launch for the bilateral (a 32 x 8
// tile and its r-pixel halo in shared memory, a pixel a thread), then one
// launch an outer TV iteration in place of the plain version's ~25 launches
// of whole-stack passes an iteration.  A TV block owns a 128 x 64 region: a
// tile and its halo of R = max(niter_inner, 1) cells.  Its 1024 threads hold
// a column strip of 8 cells each in registers (u, rhs) and meet in shared
// memory.  The block loads u, y and the previous b, computes the
// iteration's d and b from them (so only u, bx, by are state between
// launches: d is recomputed with the same bits), forms rhs, then runs the
// niter_inner sweeps over the whole region, ping-pong in shared memory; a
// cell j cells in from the region's edge is right after sweep j (temporal
// blocking), so the tile is right at the end.  It writes the tile's u and b
// to a second buffer set, so that the neighbours' halos read the old state.
// A halo cell computes exactly what its owning tile computes from the same
// inputs, so the result does not depend on the tiling; cells outside the
// image are 0 at every sweep.  The division by diag goes by its reciprocal
// and two exact corrections (`markstein`, below): the IEEE division's own
// range check and slow path, which the unlit pixels' zero and subnormal
// numerators take, cost the sweeps more than all their other work.  The
// wrapper refuses an r above MAX_RADIUS, a niter_inner above MAX_INNER (the
// halos) and a diag outside [MIN_DIAG, MAX_DIAG] (the division).
//
// Rounding: the result equals the plain version's launches on the card bit
// for bit, so the arithmetic rounds exactly where they round: every +, -
// and * is __fadd_rn / __fsub_rn / __fmul_rn (no FMA contraction) in the
// plain version's association order, every quotient is the IEEE one
// (__fdiv_rn, or `quotient`, which equals it); the scalars (inv2sc, inv2ss,
// lam = 2 eps, thresh = eps / lam, diag = mu + 4 lam) arrive as the float32
// values the plain version computes; the weight is expf, which is
// torch.exp's on the card; and the shrink is torch's sign(v) * clamp_min(|v|
// - t, 0), sign(-0) = +0 and NaN passing the clamp.  The exp and quotient
// entries at the end let the tests hold the two functions against
// torch.exp and the IEEE division on every float.
#include <cuda_runtime.h>

namespace {

// the bilateral's tile and the largest window half-width its halo holds
constexpr int BIL_X = 32;
constexpr int BIL_Y = 8;
constexpr int MAX_RADIUS = 4;
constexpr int BIL_HX = BIL_X + 2 * MAX_RADIUS;
constexpr int BIL_HY = BIL_Y + 2 * MAX_RADIUS;

// a TV block's region (its tile and the tile's halo), its threads and each
// thread's column strip, and the most sweeps the halo holds
constexpr int TV_HX = 128;
constexpr int TV_HY = 64;
constexpr int TV_STRIP = 8;
constexpr int TV_THREADS = TV_HX * TV_HY / TV_STRIP;
constexpr int MAX_INNER = 16;
// a shared array: the region and a border of one cell (0, never written)
constexpr int TV_PX = TV_HX + 2;
constexpr int TV_PN = (TV_HY + 2) * TV_PX;
constexpr size_t TV_SMEM = 3 * sizeof(float) * TV_PN;

__device__ __forceinline__ int clamp_index(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// the bilateral's weight: torch.exp on CUDA tensors is expf
__device__ __forceinline__ float weight_exp(float a) { return expf(a); }

// torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0) on CUDA tensors
__device__ __forceinline__ float shrink(float v, float t) {
  const float s = static_cast<float>((0.0f < v) - (v < 0.0f));
  const float a = __fsub_rn(fabsf(v), t);
  return __fmul_rn(s, isnan(a) ? a : fmaxf(a, 0.0f));
}

// a / d rounded as __fdiv_rn rounds it, for a divisor d in [2^-20, 2^20]
// (MIN_DIAG, MAX_DIAG) and y = RN(1 / d), without the division's range
// check and slow path, which zero and subnormal numerators take (the TV's
// unlit pixels make both), and without a call (which, even untaken, costs
// the sweeps half their speed).  A numerator in [2^-100, 2^100] takes the
// product a y and two corrections by the residual a - d q, exact with an
// FMA (Markstein: q within an ulp and y within half an ulp of 1 / d round
// the second correction correctly): `markstein`.  `rare_quotient` takes the
// others: a zero, an infinity or a NaN gives itself (d > 0); a larger
// numerator is scaled by 2^-64 and its quotient back, both exactly (an
// overflow rounds to infinity as the division does); a smaller one (the
// subnormals among them) is scaled by 2^149 to an integer a', exactly: a
// quotient a' / d of 2^23 or more scales back exactly, a smaller one is the
// subnormal quotient n 2^-149 for n = a' / d rounded to an integer, ties to
// even, which the exact residual a' - d n decides.
constexpr float MIN_DIAG = 0x1p-20f;
constexpr float MAX_DIAG = 0x1p20f;
constexpr float MARKSTEIN_MIN = 0x1p-100f;
constexpr float MARKSTEIN_MAX = 0x1p100f;

__device__ __forceinline__ float markstein(float a, float d, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-d, q, a), y, q);
  return __fmaf_rn(__fmaf_rn(-d, q, a), y, q);
}

__device__ __forceinline__ float rare_quotient(float a, float d, float y) {
  const float m = fabsf(a);
  if (m == 0.0f || isinf(a)) return a;
  if (isnan(a)) return __fmul_rn(a, y);
  if (m > MARKSTEIN_MAX) return __fmul_rn(markstein(__fmul_rn(a, 0x1p-64f), d, y), 0x1p64f);
  const float s = __fmul_rn(__fmul_rn(a, 0x1p75f), 0x1p74f);
  const float q = markstein(s, d, y);
  if (fabsf(q) >= 0x1p23f) return __fmul_rn(__fmul_rn(q, 0x1p-75f), 0x1p-74f);
  float n = rintf(q);
  const float e = __fmaf_rn(-d, n, s);
  const float twice = fabsf(__fmul_rn(2.0f, e));
  if (twice > d || (twice == d && (__float2int_rz(n) & 1))) n = __fadd_rn(n, copysignf(1.0f, e));
  return __fmul_rn(__fmul_rn(n, 0x1p-75f), 0x1p-74f);
}

__device__ __forceinline__ float quotient(float a, float d, float y) {
  const float m = fabsf(a);
  return m >= MARKSTEIN_MIN && m <= MARKSTEIN_MAX ? markstein(a, d, y) : rare_quotient(a, d, y);
}

__global__ void __launch_bounds__(BIL_X * BIL_Y)
esl_bilateral_kernel(const float* __restrict__ img, int H, int W, int r, float inv2sc,
                     float inv2ss, float* __restrict__ out) {
  __shared__ float tile[BIL_HY * BIL_HX];
  const int tw = BIL_X + 2 * r;
  const int th = BIL_Y + 2 * r;
  const int x0 = blockIdx.x * BIL_X;
  const int y0 = blockIdx.y * BIL_Y;
  const long plane = static_cast<long>(H) * W;
  const float* src = img + blockIdx.z * plane;
  // the tile and its halo, edges replicated (the plain version's pad)
  for (int i = threadIdx.y * BIL_X + threadIdx.x; i < tw * th; i += BIL_X * BIL_Y) {
    const int ty = i / tw;
    const int tx = i - ty * tw;
    const int gy = clamp_index(y0 + ty - r, H - 1);
    const int gx = clamp_index(x0 + tx - r, W - 1);
    tile[ty * BIL_HX + tx] = __ldg(src + static_cast<long>(gy) * W + gx);
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float c = tile[(threadIdx.y + r) * BIL_HX + threadIdx.x + r];
  float num = 0.0f, den = 0.0f;
  for (int dy = -r; dy <= r; ++dy) {
    const float* row = tile + (threadIdx.y + r + dy) * BIL_HX + threadIdx.x + r;
    for (int dx = -r; dx <= r; ++dx) {
      const float q = row[dx];
      const float diff = __fsub_rn(q, c);
      const float w = weight_exp(
          __fsub_rn(__fmul_rn(-__fmul_rn(diff, diff), inv2sc),
                    __fmul_rn(static_cast<float>(dy * dy + dx * dx), inv2ss)));
      num = __fadd_rn(num, __fmul_rn(w, q));
      den = __fadd_rn(den, w);
    }
  }
  out[blockIdx.z * plane + static_cast<long>(y) * W + x] = __fdiv_rn(num, den);
}

// One outer iteration of the TV denoise on a region: from u (y at the
// first iteration) and the b of the previous iteration's rhs (null: 0),
// this iteration's d and b, its rhs and its u after `inner` sweeps; writes u
// and this iteration's b (bx_out null: not written), the next launch's
// inputs, for the region's tile (the region less a halo of R cells).
// `first`: d = b = 0, as the plain version starts.
//
// A thread holds a column strip of TV_STRIP cells of the region in
// registers (u, rhs); the shared arrays give it its neighbours' values.
// Every sweep computes the whole region: a cell j cells from the region's
// edge is right after sweep j (the others read the zero border), so the
// tile, R >= inner cells in, is right at the end.
__global__ void __launch_bounds__(TV_THREADS, 1)
esl_tv_kernel(const float* __restrict__ y, const float* __restrict__ u_in,
              const float* __restrict__ bx_in, const float* __restrict__ by_in, int H, int W,
              int R, float mu, float lam, float thresh, float diag, int inner, int first,
              float* __restrict__ u_out, float* __restrict__ bx_out,
              float* __restrict__ by_out) {
  extern __shared__ float smem[];
  float* A = smem;               // u, then the even sweeps
  float* B = smem + TV_PN;       // p_x, then the odd sweeps
  float* C = smem + 2 * TV_PN;   // p_y
  const int c = threadIdx.x;                 // the strip's column in the region
  const int r0 = threadIdx.y * TV_STRIP;     // its first row
  // the region's origin in the image
  const int x0 = static_cast<int>(blockIdx.x) * (TV_HX - 2 * R) - R;
  const int y0 = static_cast<int>(blockIdx.y) * (TV_HY - 2 * R) - R;
  const long plane = static_cast<long>(H) * W;
  const long base = blockIdx.z * plane;
  const int gx = x0 + c;
  const bool col_in = static_cast<unsigned>(gx) < static_cast<unsigned>(W);
  const bool col_tile = c >= R && c < TV_HX - R;
  // a cell's shared index: row r and column c of the region, past the border
  auto at = [](int r, int col) { return (r + 1) * TV_PX + col + 1; };
  const float recip = __fdiv_rn(1.0f, diag);

  // the border, 0
  for (int i = threadIdx.y * TV_HX + c; i < TV_PN; i += TV_THREADS) {
    const int r = i / TV_PX;
    const int col = i - r * TV_PX;
    if (r == 0 || r == TV_HY + 1 || col == 0 || col == TV_PX - 1) {
      A[i] = 0.0f;
      B[i] = 0.0f;
      C[i] = 0.0f;
    }
  }

  // 1. u, y and the previous b (0 where null), 0 outside the image; the b
  //    into the p arrays, to be replaced by p
  float u[TV_STRIP];
  float yv[TV_STRIP];
  unsigned in = 0;  // bit k: cell k of the strip lies in the image
#pragma unroll
  for (int k = 0; k < TV_STRIP; ++k) {
    const int gy = y0 + r0 + k;
    const bool cell_in = col_in && static_cast<unsigned>(gy) < static_cast<unsigned>(H);
    const long g = cell_in ? base + static_cast<long>(gy) * W + gx : 0;
    in |= static_cast<unsigned>(cell_in) << k;
    u[k] = cell_in ? __ldg(u_in + g) : 0.0f;
    yv[k] = cell_in ? __ldg(y + g) : 0.0f;
    A[at(r0 + k, c)] = u[k];
    B[at(r0 + k, c)] = cell_in && bx_in ? __ldg(bx_in + g) : 0.0f;
    C[at(r0 + k, c)] = cell_in && by_in ? __ldg(by_in + g) : 0.0f;
  }
  __syncthreads();

  // 2. d and b from grad u (u less its left / upper neighbour) and the
  //    previous b, then p = d - b (0 at the first iteration and outside the
  //    image); the tile's b out
  {
    float up = A[at(r0 - 1, c)];
#pragma unroll
    for (int k = 0; k < TV_STRIP; ++k) {
      const int r = r0 + k;
      const float bxp = B[at(r, c)];
      const float byp = C[at(r, c)];
      const float gxv = __fsub_rn(u[k], A[at(r, c - 1)]);
      const float gyv = __fsub_rn(u[k], up);
      const float dx = shrink(__fadd_rn(gxv, bxp), thresh);
      const float dy = shrink(__fadd_rn(gyv, byp), thresh);
      const float bx = __fsub_rn(__fadd_rn(bxp, gxv), dx);
      const float by = __fsub_rn(__fadd_rn(byp, gyv), dy);
      const bool live = !first && (in >> k & 1u);
      B[at(r, c)] = live ? __fsub_rn(dx, bx) : 0.0f;
      C[at(r, c)] = live ? __fsub_rn(dy, by) : 0.0f;
      up = u[k];
      if (bx_out && live && col_tile && r >= R && r < TV_HY - R) {
        const long g = base + static_cast<long>(y0 + r) * W + gx;
        bx_out[g] = bx;
        by_out[g] = by;
      }
    }
  }
  __syncthreads();

  // 3. rhs = mu y - lam ((p_x[x + 1] - p_x) + (p_y[y + 1] - p_y))
  float rhs[TV_STRIP];
#pragma unroll
  for (int k = 0; k < TV_STRIP; ++k) {
    const int r = r0 + k;
    const float div = __fadd_rn(__fsub_rn(B[at(r, c + 1)], B[at(r, c)]),
                                __fsub_rn(C[at(r + 1, c)], C[at(r, c)]));
    rhs[k] = __fsub_rn(__fmul_rn(mu, yv[k]), __fmul_rn(lam, div));
  }
  __syncthreads();

  // 4. the sweeps: u = (rhs + lam (((u[x + 1] + u[x - 1]) + u[y + 1]) + u[y - 1])) / diag,
  //    every cell's numerator first, then the quotients
  float* src = A;
  float* dst = B;
  for (int j = 1; j <= inner; ++j) {
    float num[TV_STRIP];
#pragma unroll
    for (int k = 0; k < TV_STRIP; ++k) {
      const int r = r0 + k;
      const float up = k > 0 ? u[k - 1] : src[at(r0 - 1, c)];
      const float down = k + 1 < TV_STRIP ? u[k + 1] : src[at(r0 + TV_STRIP, c)];
      const float neigh =
          __fadd_rn(__fadd_rn(__fadd_rn(src[at(r, c + 1)], src[at(r, c - 1)]), down), up);
      num[k] = __fadd_rn(rhs[k], __fmul_rn(lam, neigh));
    }
    // the strip's nonzero numerators' least and largest magnitudes (NaNs
    // left out: their product is NaN as their quotient is); a zero's
    // product has the zero's sign once copied back
    float lo = MARKSTEIN_MAX, hi = 0.0f;
#pragma unroll
    for (int k = 0; k < TV_STRIP; ++k) {
      const float m = fabsf(num[k]);
      u[k] = (in >> k & 1u) ? copysignf(markstein(num[k], diag, recip), num[k]) : 0.0f;
      lo = fminf(lo, m > 0.0f ? m : MARKSTEIN_MAX);
      hi = fmaxf(hi, m);
      dst[at(r0 + k, c)] = u[k];
    }
    if (lo < MARKSTEIN_MIN || hi > MARKSTEIN_MAX) {
      // a numerator out of markstein's range in the strip: every cell
      // again through the exact path, one at a time, the numerators parked
      // in the free p_y array
#pragma unroll
      for (int k = 0; k < TV_STRIP; ++k) C[at(r0 + k, c)] = num[k];
#pragma unroll 1
      for (int k = 0; k < TV_STRIP; ++k) {
        if (in >> k & 1u) dst[at(r0 + k, c)] = quotient(C[at(r0 + k, c)], diag, recip);
      }
#pragma unroll
      for (int k = 0; k < TV_STRIP; ++k) u[k] = dst[at(r0 + k, c)];
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }

  // 5. the tile's u out
  if (col_tile) {
#pragma unroll
    for (int k = 0; k < TV_STRIP; ++k) {
      const int r = r0 + k;
      if ((in >> k & 1u) && r >= R && r < TV_HY - R) {
        u_out[base + static_cast<long>(y0 + r) * W + gx] = u[k];
      }
    }
  }
}

__global__ void esl_denoise_exp_kernel(const float* __restrict__ x, long n,
                                       float* __restrict__ out) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    out[i] = weight_exp(x[i]);
  }
}

}  // namespace

// The bilateral filter of each (H, W) slice of img into out (not img).
extern "C" int esl_bilateral(const float* img, int F, int H, int W, int r, float inv2sc,
                             float inv2ss, float* out, cudaStream_t stream) {
  if (r < 0 || r > MAX_RADIUS) return static_cast<int>(cudaErrorInvalidValue);
  if (F > 0 && H > 0 && W > 0) {
    const dim3 grid((W + BIL_X - 1) / BIL_X, (H + BIL_Y - 1) / BIL_Y, F);
    esl_bilateral_kernel<<<grid, dim3(BIL_X, BIL_Y), 0, stream>>>(img, H, W, r, inv2sc,
                                                                   inv2ss, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int esl_tv_iteration(const float* y, const float* u_in, const float* bx_in,
                                const float* by_in, int F, int H, int W, float mu, float lam,
                                float thresh, float diag, int inner, int first, float* u_out,
                                float* bx_out, float* by_out, cudaStream_t stream) {
  if (inner < 0 || inner > MAX_INNER || !(diag >= MIN_DIAG && diag <= MAX_DIAG) ||
      (bx_in == nullptr) != (by_in == nullptr) || (bx_out == nullptr) != (by_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (F > 0 && H > 0 && W > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        esl_tv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(TV_SMEM));
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    const int R = inner > 1 ? inner : 1;  // the halo
    const int tx = TV_HX - 2 * R;
    const int ty = TV_HY - 2 * R;
    const dim3 grid((W + tx - 1) / tx, (H + ty - 1) / ty, F);
    esl_tv_kernel<<<grid, dim3(TV_HX, TV_HY / TV_STRIP), TV_SMEM, stream>>>(
        y, u_in, bx_in, by_in, H, W, R, mu, lam, thresh, diag, inner, first, u_out, bx_out,
        by_out);
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void esl_denoise_quotient_kernel(const float* __restrict__ x, long n, float d,
                                            float* __restrict__ out) {
  const float y = __fdiv_rn(1.0f, d);
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    out[i] = quotient(x[i], d, y);
  }
}

// The sweeps' division by d (in [MIN_DIAG, MAX_DIAG]) of n floats, for the
// tests that hold it against torch's division.
extern "C" int esl_denoise_quotient(const float* x, long n, float d, float* out,
                                    cudaStream_t stream) {
  if (!(d >= MIN_DIAG && d <= MAX_DIAG)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const long blocks = (n + 255) / 256;
    const dim3 grid(static_cast<unsigned>(blocks < 65536 ? blocks : 65536));
    esl_denoise_quotient_kernel<<<grid, dim3(256), 0, stream>>>(x, n, d, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bilateral's weight function on n floats, for the tests that hold it
// against torch.exp.
extern "C" int esl_denoise_exp(const float* x, long n, float* out, cudaStream_t stream) {
  if (n > 0) {
    const long blocks = (n + 255) / 256;
    const dim3 grid(static_cast<unsigned>(blocks < 65536 ? blocks : 65536));
    esl_denoise_exp_kernel<<<grid, dim3(256), 0, stream>>>(x, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
