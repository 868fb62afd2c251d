// Kernel A: esl_disparity_search -- the ESL-init disparity search over the
// camera footprint box, as a per-pixel binary search.
//
// Replaces the TPU kernel esl_disparity_search (xmaps_tpu/ops/pallas_esl.py
// :281, body _kernel :96-190).  For every nonzero rectified camera pixel c
// of a row it finds j0 = the first column in [c + min_disp, min(c +
// max_disp, W)) whose suffix-filled projector value G[j] >= cam (the
// projector rows are monotone, ops/esl_search.rows_monotone), then picks
// between the two candidates around j0 -- the first nonzero at or after j0
// and the last one before it, clamped into the window -- by float32 squared
// error, ties to the lower column (np.argmin's first minimum), and accepts
// the pixel when the window holds at least two nonzero projector values.
// The tables G, F, N, R, C are the per-row scans of esl_search_prep.
//
// What bounds it on the H100: dependent loads.  Each pixel does an
// 11-step binary search (one 4 B load per step, each depending on the
// previous) and 8 table loads; neighbouring threads search neighbouring,
// overlapping windows of the same row, so the loads coalesce and hit L1/L2.
// At the ESL geometry the box is ~9 Mpx and the five tables ~180 MB: they
// do not fit the 50 MB L2, but each row's window is touched by a few warps
// at once.
//
// What the design does about it: one thread per box pixel with plain
// global loads.  The TPU kernel's lane-group decomposition of each row
// gather (gather_row, :121-144: up to 9 static 128-lane tiles and a
// select) existed because a TPU gather is a lane shuffle inside VMEM; here
// a direct indexed load replaces it.  Zero camera pixels (most of the box)
// write 0 and return at once.  The window clip W = min(W_loc, W_pad) of the
// JAX kernel is passed in, and the tables are padded to W_pad columns as
// there, so the result is bit-identical.  The two squared errors use
// explicit round-to-nearest intrinsics so that nothing is contracted.
#include "common.cuh"

namespace {

__global__ void esl_search_kernel(
    const float* __restrict__ cam, int Hc, int Wc,
    const float* __restrict__ G, const float* __restrict__ F,
    const int32_t* __restrict__ N, const int32_t* __restrict__ R,
    const int32_t* __restrict__ C, int W_pad, int W, int min_disp,
    int max_disp, int steps, float* __restrict__ out) {
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long>(Hc) * Wc) return;
  const float v = cam[idx];
  if (v == 0.0f) {  // the acceptance test requires cam != 0
    out[idx] = 0.0f;
    return;
  }
  const int r = static_cast<int>(idx / Wc);
  const int c = static_cast<int>(idx - static_cast<long>(r) * Wc);
  const long row = static_cast<long>(r) * W_pad;
  const int last = W_pad - 1;

  // binary search: first j in [lo, hi) with G[j] >= cam (hi if none)
  const int lo = c + min_disp;
  const int hi = min(c + max_disp, W);
  int l = lo;
  int rr = hi;
  for (int s = 0; s < steps; ++s) {
    const int m = min((l + rr) >> 1, last);
    const bool cond = __ldg(G + row + m) >= v;
    rr = cond ? m : rr;
    l = cond ? l : m + 1;
  }
  const int j0 = min(rr, hi);
  const int j0c = min(j0, last);
  const int j0m1 = min(max(j0 - 1, 0), last);

  const float w_u = __ldg(G + row + j0c);
  const int cu = __ldg(N + row + j0c);
  const float w_l = __ldg(F + row + j0m1);
  const int rl = __ldg(R + row + j0m1);
  const int cnt_lo = __ldg(C + row + min(max(lo - 1, 0), last));
  const int cnt_j0 = __ldg(C + row + j0m1);
  const int cnt_hi = __ldg(C + row + min(max(hi - 1, 0), last));
  const int n_lo = __ldg(N + row + min(lo, last));

  const int cnt_before_lo = lo >= 1 ? cnt_lo : 0;
  const bool has_upper = j0 < hi && cu < hi;
  const bool has_lower = j0 > lo && cnt_j0 - cnt_before_lo >= 1;
  const int cl = max(rl, n_lo);  // the lower run clamped into the window
  const float du = __fsub_rn(w_u, v);
  const float dl = __fsub_rn(v, w_l);
  const float du2 = __fmul_rn(du, du);
  const float dl2 = __fmul_rn(dl, dl);
  // np.argmin first minimum: the lower candidate sits at the smaller column
  const bool pick_lower = has_lower && (!has_upper || dl2 <= du2);
  const int best = pick_lower ? cl : cu;
  const bool chosen = has_lower || has_upper;
  const bool ok = cnt_hi - cnt_before_lo > 1 && chosen && c < W;
  out[idx] = ok ? static_cast<float>(best - c) : 0.0f;
}

}  // namespace

extern "C" int esl_disparity_search(
    const float* cam, int Hc, int Wc, const float* G, const float* F,
    const int32_t* N, const int32_t* R, const int32_t* C, int W_pad, int W,
    int min_disp, int max_disp, int steps, float* out, cudaStream_t stream) {
  constexpr int threads = 256;
  const long n = static_cast<long>(Hc) * Wc;
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
    esl_search_kernel<<<blocks, threads, 0, stream>>>(
        cam, Hc, Wc, G, F, N, R, C, W_pad, W, min_disp, max_disp, steps, out);
  }
  return static_cast<int>(cudaGetLastError());
}
