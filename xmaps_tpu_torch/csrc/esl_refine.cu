// Kernel R: esl_refine -- ESL's depth refinement (reference
// eval/compute_depth_esl.py depth_optimization, :104-129) of every pixel of
// an (F, H, W) group of scans in one launch.
//
// What it computes: for each pixel with depth0 > 0 at least ws pixels from
// every border, the stencil sums S0 = sum c^2, S1 = sum c and X1 = sum c b_k
// of the filled camera image over the (2w + 1)^2 window (b_k the window
// pixel's projector time offset), base = (S0 - 2 X1) + B2, then two grid
// searches of iters + 1 samples each of the closed-form window cost
//     cost(rho) = base - 2 a S1 + K a^2   (in bounds; else OOB_COST)
// where a is the projector scan time at the pixel's ray reprojected at depth
// rho (rigid motion, the projector's distortion and intrinsics, truncated to
// an integer projector pixel): the first over [depth0 - diff, depth0 +
// diff], diff = depth0^2 / p03, the second within one coarse step of the
// best sample, every sample clamped to the first range and the first minimum
// winning.  Every other pixel is 0.  The plain version, whose launches this
// kernel replaces, is ops/esl_refine.py esl_refine_plain.
//
// It replaces no TPU kernel: the JAX package's refinement
// (xmaps_tpu/apps/eval_esl.py:144) is plain XLA with no Pallas kernel.  It
// was added because the port's plain version, about 13,500 PyTorch
// elementwise launches a group of 12 scans (each over the whole 14.7 MB
// stack), left the esl-gt-scan-groups benchmark cell bound by the host's
// issue of those launches: the refinement took 71 % of a call.
//
// What bounds it on the H100: FP32 instruction issue.  A group of 12 ESL
// scans moves about 47 MB (the camera stack, depth0, the rays once, the
// result), ~14 us at 3.35 TB/s, while each optimised pixel (~40 % of the
// camera) runs 2 (iters + 1) = 130 cost evaluations of about 100 FP32
// instructions (two IEEE divisions among them) from registers.
//
// What the design does about it: one thread a pixel, everything in
// registers; a block is a 32 x 8 tile of one scan (the scan on blockIdx.z)
// that stages the tile and its w-pixel halo of the camera image in shared
// memory for the stencil sums.  Pixels outside the optimised set write 0 and
// retire after the staging.  w is at most MAX_W (the shared tile's halo);
// the wrapper refuses a larger one.
//
// Rounding: the result equals the plain version's launches on the card bit
// for bit, so the arithmetic rounds exactly where they round.  Every +, - ,
// * and / is __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn (no FMA
// contraction, no reciprocal multiply the plain version does not have), in
// the plain version's association order; its Python constants arrive as the
// float32 roundings it uses (the constant block of
// ops/esl_refine.constant_block); zp == 0 becomes 1e-12; the float -> int32
// casts saturate with NaN -> 0 (__float2int_rz, as to_int32_saturating);
// the int32 bounds test and the scan-time index wrap as int32 arithmetic
// does (done in unsigned); and the clamp keeps torch.clamp's NaN rules.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 8;
// the largest window half-width the shared tile's halo holds
constexpr int MAX_W = 8;
constexpr int HALO_X = TILE_X + 2 * MAX_W;
constexpr int HALO_Y = TILE_Y + 2 * MAX_W;

// the constant block's layout (ops/esl_refine.py CONSTANTS names them)
constexpr int C_R = 0;         // R, row-major (9)
constexpr int C_T = 9;         // T (3)
constexpr int C_FX = 12, C_CX = 13, C_FY = 14, C_CY = 15;
constexpr int C_K1 = 16, C_K2 = 17, C_P1 = 18, C_P2 = 19, C_K3 = 20;
constexpr int C_2P1 = 21, C_2P2 = 22;
constexpr int C_INV_N = 23, C_B2 = 24, C_INV_P03 = 25, C_INV_ITERS = 26;
constexpr int C_TINY = 27, C_OOB = 28;
constexpr int C_TAPS = 32;     // the (2w + 1)^2 tap weights, dy outer

// the reprojection's constants, in registers
struct Projection {
  float R[9], T[3], fx, cx, fy, cy, k1, k2, p1, p2, k3, p1x2, p2x2;
  float inv_n, tiny, oob, Kf;
  int w, Hp, Wp;
};

// torch.clamp(v, lo, hi) on CUDA tensors: NaN in v, then lo, then hi wins
__device__ __forceinline__ float clamp_torch(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// int32 a + b and a * b wrapping as int32 tensors do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// the window cost at depth rho (the plain version's cost(rho))
__device__ __forceinline__ float window_cost(const Projection& c, float xn, float yn,
                                             float base, float S1, float rho) {
  const float X = __fmul_rn(xn, rho);
  const float Y = __fmul_rn(yn, rho);
  const float Z = rho;
  const float xp = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.R[0], X), __fmul_rn(c.R[1], Y)),
                                       __fmul_rn(c.R[2], Z)), c.T[0]);
  const float yp = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.R[3], X), __fmul_rn(c.R[4], Y)),
                                       __fmul_rn(c.R[5], Z)), c.T[1]);
  float zp = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.R[6], X), __fmul_rn(c.R[7], Y)),
                                 __fmul_rn(c.R[8], Z)), c.T[2]);
  zp = (zp == 0.0f) ? c.tiny : zp;
  const float u = __fdiv_rn(xp, zp);
  const float v = __fdiv_rn(yp, zp);
  const float r2 = __fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v));
  const float radial = __fadd_rn(
      1.0f, __fmul_rn(r2, __fadd_rn(c.k1, __fmul_rn(r2, __fadd_rn(c.k2, __fmul_rn(r2, c.k3))))));
  // ud = u * radial + (2 p1) * u * v + p2 * (r2 + 2 * u * u)
  const float ud = __fadd_rn(
      __fadd_rn(__fmul_rn(u, radial), __fmul_rn(__fmul_rn(c.p1x2, u), v)),
      __fmul_rn(c.p2, __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, u), u))));
  // vd = v * radial + p1 * (r2 + 2 * v * v) + (2 p2) * u * v
  const float vd = __fadd_rn(
      __fadd_rn(__fmul_rn(v, radial),
                __fmul_rn(c.p1, __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, v), v)))),
      __fmul_rn(__fmul_rn(c.p2x2, u), v));
  const float px = __fadd_rn(__fmul_rn(c.fx, ud), c.cx);
  const float py = __fadd_rn(__fmul_rn(c.fy, vd), c.cy);
  const int xi = __float2int_rz(px);  // saturating, NaN -> 0
  const int yi = __float2int_rz(py);
  const bool inside = wrap_add(yi, -c.w) > 0 && wrap_add(yi, c.w) < c.Hp &&
                      wrap_add(xi, -c.w) > 0 && wrap_add(xi, c.w) < c.Wp;
  const float a = __fmul_rn(__int2float_rn(wrap_add(wrap_mul(xi, c.Hp), yi)), c.inv_n);
  const float quad = __fadd_rn(__fsub_rn(base, __fmul_rn(__fmul_rn(2.0f, a), S1)),
                               __fmul_rn(__fmul_rn(c.Kf, a), a));
  return inside ? quad : c.oob;
}

// iters + 1 samples from center - radius in steps of 2 radius / iters,
// clamped to [lo, hi]; the first minimum wins.  Returns the best sample and
// sets *step.
__device__ __forceinline__ float grid_minimize(const Projection& c, float xn, float yn,
                                               float base, float S1, float center, float radius,
                                               float lo, float hi, int iters, float inv_iters,
                                               float* step) {
  const float s = __fmul_rn(__fmul_rn(2.0f, radius), inv_iters);
  const float start = __fsub_rn(center, radius);
  float best_cost = INFINITY;
  float best = center;
  for (int i = 0; i <= iters; ++i) {
    const float x = clamp_torch(__fadd_rn(start, __fmul_rn(static_cast<float>(i), s)), lo, hi);
    const float f = window_cost(c, xn, yn, base, S1, x);
    if (f < best_cost) {
      best_cost = f;
      best = x;
    }
  }
  *step = s;
  return best;
}

__global__ void __launch_bounds__(TILE_X * TILE_Y)
esl_refine_kernel(const float* __restrict__ depth0, const float* __restrict__ cam,
                  const float* __restrict__ xn, const float* __restrict__ yn,
                  const float* __restrict__ consts, int H, int W, int w, int ws, int Hp,
                  int Wp, int iters, float* __restrict__ out) {
  __shared__ float tile[HALO_Y * HALO_X];
  const int tw = TILE_X + 2 * w;
  const int th = TILE_Y + 2 * w;
  const int x0 = blockIdx.x * TILE_X;
  const int y0 = blockIdx.y * TILE_Y;
  const long plane = static_cast<long>(H) * W;
  const float* img = cam + blockIdx.z * plane;
  // the tile and its halo, 0 outside the image (the plain version's pad)
  for (int i = threadIdx.y * TILE_X + threadIdx.x; i < tw * th; i += TILE_X * TILE_Y) {
    const int ty = i / tw;
    const int tx = i - ty * tw;
    const int gy = y0 + ty - w;
    const int gx = x0 + tx - w;
    tile[ty * HALO_X + tx] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W) ? __ldg(img + gy * W + gx) : 0.0f;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const long idx = blockIdx.z * plane + static_cast<long>(y) * W + x;
  const float d0 = __ldg(depth0 + idx);
  const bool region = y >= ws && y < H - ws && x >= ws && x < W - ws;
  if (!(d0 > 0.0f) || !region) {
    out[idx] = 0.0f;
    return;
  }

  // stencil sums, each from 0, dy outer and dx inner
  float S0 = 0.0f, S1 = 0.0f, X1 = 0.0f;
  int k = 0;
  for (int dy = -w; dy <= w; ++dy) {
    const float* row = tile + (threadIdx.y + w + dy) * HALO_X + threadIdx.x + w;
    for (int dx = -w; dx <= w; ++dx, ++k) {
      const float v = row[dx];
      S0 = __fadd_rn(S0, __fmul_rn(v, v));
      S1 = __fadd_rn(S1, v);
      X1 = __fadd_rn(X1, __fmul_rn(v, __ldg(consts + C_TAPS + k)));
    }
  }
  const float base = __fadd_rn(__fsub_rn(S0, __fmul_rn(2.0f, X1)), __ldg(consts + C_B2));

  Projection c;
#pragma unroll
  for (int j = 0; j < 9; ++j) c.R[j] = __ldg(consts + C_R + j);
#pragma unroll
  for (int j = 0; j < 3; ++j) c.T[j] = __ldg(consts + C_T + j);
  c.fx = __ldg(consts + C_FX);
  c.cx = __ldg(consts + C_CX);
  c.fy = __ldg(consts + C_FY);
  c.cy = __ldg(consts + C_CY);
  c.k1 = __ldg(consts + C_K1);
  c.k2 = __ldg(consts + C_K2);
  c.p1 = __ldg(consts + C_P1);
  c.p2 = __ldg(consts + C_P2);
  c.k3 = __ldg(consts + C_K3);
  c.p1x2 = __ldg(consts + C_2P1);
  c.p2x2 = __ldg(consts + C_2P2);
  c.inv_n = __ldg(consts + C_INV_N);
  c.tiny = __ldg(consts + C_TINY);
  c.oob = __ldg(consts + C_OOB);
  c.Kf = static_cast<float>((2 * w + 1) * (2 * w + 1));
  c.w = w;
  c.Hp = Hp;
  c.Wp = Wp;
  const float inv_iters = __ldg(consts + C_INV_ITERS);
  const long ray = static_cast<long>(y) * W + x;
  const float rx = __ldg(xn + ray);
  const float ry = __ldg(yn + ray);

  const float diff = __fmul_rn(__fmul_rn(d0, d0), __ldg(consts + C_INV_P03));
  const float lo = __fsub_rn(d0, diff);
  const float hi = __fadd_rn(d0, diff);
  float step1, step2;
  const float x1 = grid_minimize(c, rx, ry, base, S1, d0, diff, lo, hi, iters, inv_iters, &step1);
  out[idx] = grid_minimize(c, rx, ry, base, S1, x1, step1, lo, hi, iters, inv_iters, &step2);
}

}  // namespace

extern "C" int esl_refine(const float* depth0, const float* cam, const float* xn,
                          const float* yn, const float* consts, int F, int H, int W, int w,
                          int ws, int Hp, int Wp, int iters, float* out, cudaStream_t stream) {
  if (w < 0 || w > MAX_W) return static_cast<int>(cudaErrorInvalidValue);
  if (F > 0 && H > 0 && W > 0) {
    const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y, F);
    esl_refine_kernel<<<grid, dim3(TILE_X, TILE_Y), 0, stream>>>(
        depth0, cam, xn, yn, consts, H, W, w, ws, Hp, Wp, iters, out);
  }
  return static_cast<int>(cudaGetLastError());
}
