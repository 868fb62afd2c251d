"""The plain reference of ESL's depth of one scan (the ``esl-gt`` cells).

Plain PyTorch on any device (the benchmark runs it on the card once the
program is freed, the tests on the CPU), float32 with TF32 off, written
from ESL's published pipeline (Muglikar, Gallego, Scaramuzza, ESL:
Event-based Structured Light, 3DV 2021; its ``compute_depth_esl.py`` and
``esl_utilities.py`` as X-maps' ``eval/x-map-eval.sh`` runs them).  It
imports neither JAX nor the system under test; the rig's host math is
``benchmark.reference.calib``'s.  A scan is a camera time map (0 where the
scan never reached), and its four planes are:

1. normalise (:205-209): the lit times to [0, 1] by their minimum and
   maximum, negatives (the unlit pixels) to 0;
2. init (:72-85): the scan rectified (nearest, 0 outside the camera); for
   every rectified pixel c of a row the disparity d in [5, 900) whose
   projector time at column c + d is nearest the pixel's (first minimum;
   0 beyond the frame), kept where the pixel is nonzero and at least two
   projector times lie in the window; the brute force over all 895
   shifts, in row blocks; gathered back to the camera (nearest, 0 outside
   the frame): ``disparity_init``; ``depth_init`` = P2[0, 3] / disparity
   (0 where the disparity is), a float32 quotient;
3. refinement (:104-129): each pixel with depth > 0 at least W = 7 pixels
   inside every border minimises, over [d - d^2 / P2[0, 3], d + d^2 /
   P2[0, 3]], the window's squared difference between the scan (its empty
   pixels filled with 1 / its pixel (0, 0), :211) and the projector's
   time at each pixel reprojected through the plane at that depth (the
   truncated projector pixel's column-major index over the projector's
   pixel count; 1e10 where the window leaves the projector);
   ``depth_optim``;
4. a bilateral filter (d 5, sigma 3 / 3, edges replicated) and an
   anisotropic TV-L2 denoise by split Bregman (mu 0.5, eps 0.1, 20 outer
   iterations): ``depth_optim_filtered``.

Departures from ESL, both the system's, each written where it applies:
(A) the refinement's bounded ``minimize_scalar`` is a two-level grid of
65 samples each (the cost is piecewise constant in depth, so a grid finds
its minimum where Brent's method may stop in a step); (B) the TV denoise's
inner solve, pylops' LSQR, is 10 Jacobi sweeps.  Its rounding points are
the ones the system documents (the window's cost in closed form, B2 summed
in float64 on the host, the division by P2[0, 3] and by the grid's count
a multiplication by float32 reciprocals, saturating float -> int32 casts),
so that a float32 run of the same scan gives the same bits.

``lower=True`` runs the refinement and the denoise in bfloat16, one
precision step below the configuration's float32: the control the
comparison has to fail.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import calib as ref_calib

MIN_DISP, MAX_DISP = 5, 900
OOB_COST = 1.0e10
#: elements of a row block of the brute-force search
BLOCK_ELEMENTS = 1 << 24


def _f32(v) -> float:
    return float(np.float32(v))


def tables(rig: dict) -> dict:
    """The host tables of an ESL rig (a configuration's ``rig``): the
    rectification's gathers (flat indices, -1 for 0), the rectified
    projector time map, P2[0, 3] and the refinement's rays and geometry.

    The projector is the first view of the stereo pair; its distortion is
    left out of its rectification map (ESL's ``zero_undistort``), and it
    scans column by column, each column downwards."""
    cam = (rig["camera_width"], rig["camera_height"])
    proj = (rig["projector_width"], rig["projector_height"])
    rect = (rig["rect_width"], rig["rect_height"])
    Kc, Dc = np.array(rig["camera_K"], float), np.array(rig["camera_D"], float)
    Kp, Dp = np.array(rig["projector_K"], float), np.array(rig["projector_D"], float)
    R1, R2, P1, P2 = ref_calib.stereo_rectify(Kp, Dp, Kc, Dc, rect, rig["cam2proj_R"],
                                              rig["cam2proj_T"])
    # rectify: rectified pixel <- camera pixel
    fx, fy = ref_calib.forward_map(Kc, Dc, R1, P1, rect)
    fwd = _flat_index(fx, fy, cam)
    # back: camera pixel <- rectified pixel (cv2.initInverseRectificationMap)
    xs, ys = np.meshgrid(np.arange(cam[0]), np.arange(cam[1]))
    coords = np.stack([xs, ys], axis=-1).astype(np.float32).astype(np.float64)
    back = ref_calib.undistort_points(coords, Kc, Dc, R=R1, P=P1).astype(np.float32)
    back = _flat_index(back[..., 0], back[..., 1], rect)
    # the projector's time map, column-major, each column downwards
    ym, xm = np.mgrid[0:proj[1], 0:proj[0]]
    time_map = ((xm * proj[1] + ym) / (proj[0] * proj[1])).astype(np.float32)
    px, py = ref_calib.forward_map(Kp, np.zeros(5), R2, P2, rect)
    proj_rect = ref_calib.remap_nearest_constant(time_map, px, py)
    # the refinement's rays: each camera pixel undistorted, normalised
    pts = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)
    und = ref_calib.undistort_points(pts.astype(np.float64), Kc, Dc, P=Kc)
    x_n = ((und[:, 0] - Kc[0, 2]) / Kc[0, 0]).reshape(cam[1], cam[0]).astype(np.float32)
    y_n = ((und[:, 1] - Kc[1, 2]) / Kc[1, 1]).reshape(cam[1], cam[0]).astype(np.float32)
    return dict(fwd=fwd, back=back, proj_rect=proj_rect, p03=np.float64(P2[0, 3]),
                x_n=x_n, y_n=y_n, R=np.array(rig["cam2proj_R"], np.float32),
                T=np.array(rig["cam2proj_T"], np.float32).reshape(3),
                proj_K=np.array(rig["projector_K"], np.float32),
                proj_D=np.resize(np.array(rig["projector_D"], np.float32), 5),
                proj_size=np.array(proj))


def _flat_index(map_x, map_y, src) -> np.ndarray:
    """cv2.remap(INTER_NEAREST, BORDER_CONSTANT) as a gather: the flat
    index of the source pixel each destination reads (the float32 maps
    rounded half to even), -1 where it lies outside the source."""
    W, H = src
    xi = np.rint(map_x).astype(np.int64)
    yi = np.rint(map_y).astype(np.int64)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    return np.where(inb, yi * W + xi, -1).astype(np.int32)


#: ESL's settings (compute_depth_esl.py, esl_utilities.py; X-maps' W = 7)
SETTINGS = dict(refine=dict(window_size=7, iters=64),
                bilateral=dict(d=5, sigma_color=3.0, sigma_space=3.0),
                tv_denoise=dict(mu=0.5, eps=0.1, niter=20, niter_inner=10))


class Reference:
    """The tables on ``device``, and the planes of a scan under
    ``settings`` (``SETTINGS``' keys, a configuration's values)."""

    def __init__(self, tabs: dict, device, settings: dict = SETTINGS):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.tabs = tabs
        self.settings = {k: settings[k] for k in SETTINGS}
        on = {k: torch.from_numpy(np.ascontiguousarray(tabs[k])).to(self.device)
              for k in ("fwd", "back", "proj_rect", "x_n", "y_n")}
        self.fwd, self.back, self.proj_rect = on["fwd"], on["back"], on["proj_rect"]
        self.x_n, self.y_n = on["x_n"], on["y_n"]
        self.p03 = float(tabs["p03"])

    def planes(self, scan: np.ndarray, lower: bool = False) -> dict:
        """The four planes of one scan, float32 (H, W) tensors on the device."""
        cam = torch.from_numpy(normalize(scan)).to(self.device)
        disp = self.disparity(cam)
        depth = torch.where(disp != 0, torch.full_like(disp, self.p03) / disp, 0.0)
        dt = torch.bfloat16 if lower else torch.float32
        img = torch.where(cam == 0, 1.0 / cam[0, 0], cam)  # :211, 1 / 0 is inf
        optim = refine(depth.to(dt), img.to(dt), self, dt, **self.settings["refine"])
        filtered = tv_denoise(bilateral(optim, **self.settings["bilateral"]),
                              **self.settings["tv_denoise"])
        return dict(disparity_init=disp, depth_init=depth, depth_optim=optim.float(),
                    depth_optim_filtered=filtered.float())

    def rectify(self, cam: torch.Tensor) -> torch.Tensor:
        """The scan in the rectified frame (nearest, 0 outside the camera)."""
        H, W = self.tabs["proj_rect"].shape
        return gather(cam, self.fwd).reshape(H, W)

    def disparity(self, cam: torch.Tensor) -> torch.Tensor:
        """``disparity_init``: the brute-force search on the rectified scan,
        gathered back to the camera."""
        rect = self.rectify(cam)
        H, W = rect.shape
        disp = torch.zeros_like(rect)
        rows = torch.nonzero((rect != 0).any(1)).flatten().tolist()
        if rows:
            cols = torch.nonzero((rect != 0).any(0)).flatten()
            c0, c1 = int(cols[0]), int(cols[-1]) + 1
            n = c1 - c0
            step = max(BLOCK_ELEMENTS // (n + MAX_DISP), 1)
            for r0 in range(rows[0], rows[-1] + 1, step):
                r1 = min(r0 + step, rows[-1] + 1)
                disp[r0:r1, c0:c1] = search(rect[r0:r1, c0:c1],
                                            self.proj_rect[r0:r1, c0:min(c1 + MAX_DISP, W)])
        return gather(disp, self.back).reshape(cam.shape)


def normalize(scan: np.ndarray) -> np.ndarray:
    """:205-209: the lit values to [0, 1], negatives to 0, float32."""
    lit = scan[scan != 0]
    out = (scan - lit.min()) / (lit.max() - lit.min())
    out[out < 0] = 0
    return out.astype(np.float32)


def gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src.flat[idx]``, 0 where ``idx`` is -1."""
    flat = torch.cat([src.reshape(-1), src.new_zeros(1)])
    i = idx.long()
    return flat[torch.where(i >= 0, i, flat.numel() - 1)]


def search(cam: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """:72-85 on a block of rows: ``cam`` (B, n) rectified times, ``proj``
    (B, <= n + 900) the projector's times from the block's first column
    on; the disparity of each pixel (0: none)."""
    B, n = cam.shape
    pad = torch.cat([proj, proj.new_zeros((B, n + MAX_DISP - proj.shape[1]))], 1)
    count = torch.zeros((B, n), dtype=torch.int32, device=cam.device)
    best_cost = torch.full((B, n), torch.inf, device=cam.device)
    best_d = torch.zeros((B, n), dtype=torch.int32, device=cam.device)
    for d in range(MIN_DISP, MAX_DISP):
        p = pad[:, d:d + n]
        valid = p != 0
        diff = p - cam
        cost = diff * diff
        better = valid & (cost < best_cost)  # the first minimum wins
        count += valid
        best_cost = torch.where(better, cost, best_cost)
        best_d = torch.where(better, d, best_d)
    return torch.where((cam != 0) & (count > 1), best_d, 0).float()


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncation, saturating beyond the range and 0 for NaN
    (the system's cast; a plain cast is undefined there)."""
    big = x >= 2.0**31
    t = torch.where(torch.isnan(x) | big, 0.0, x).clamp_min(-(2.0**31)).int()
    return torch.where(big, 2**31 - 1, t)


def refine(depth0: torch.Tensor, cam: torch.Tensor, ref: Reference, dt, *,
           window_size: int, iters: int) -> torch.Tensor:
    """:104-129, departure (A): ``depth0`` and the filled ``cam`` (H, W)
    in ``dt``; the refined depth (0 outside the optimised pixels)."""
    tabs = ref.tabs
    ws = int(window_size)
    w = ws // 2
    Wp, Hp = (int(v) for v in tabs["proj_size"])
    H, W = cam.shape
    inv_n = 1.0 / (Wp * Hp)
    # the window's cost, sum_k (cam_k - (a + b_k))^2 with b_k the time
    # offset of window pixel k, expanded: C0 - 2 a S1 + K a^2, where
    # C0 = sum cam_k^2 - 2 sum cam_k b_k + sum b_k^2 (summed in this order)
    pad = F.pad(cam, (w, w, w, w))
    S0 = torch.zeros_like(cam)
    S1 = torch.zeros_like(cam)
    X1 = torch.zeros_like(cam)
    B2 = 0.0
    for dy in range(-w, w + 1):
        for dx in range(-w, w + 1):
            c = pad[w + dy:w + dy + H, w + dx:w + dx + W]
            b = (dx * Hp + dy) * inv_n
            S0 = S0 + c * c
            S1 = S1 + c
            X1 = X1 + c * _f32(b)
            B2 += b * b
    base = (S0 - 2.0 * X1) + _f32(B2)
    K = (2 * w + 1) ** 2
    xn, yn = ref.x_n.to(dt), ref.y_n.to(dt)
    R = [[float(v) for v in row] for row in tabs["R"]]
    T = [float(v) for v in tabs["T"]]
    pK = tabs["proj_K"]
    k1, k2, p1, p2, k3 = (float(v) for v in tabs["proj_D"])
    tiny = torch.full((), _f32(1e-12), dtype=dt, device=cam.device)
    oob = torch.full((), _f32(OOB_COST), dtype=dt, device=cam.device)

    def cost(rho):
        # the camera ray at depth rho, into the projector (:27-42)
        X, Y, Z = xn * rho, yn * rho, rho
        xp = R[0][0] * X + R[0][1] * Y + R[0][2] * Z + T[0]
        yp = R[1][0] * X + R[1][1] * Y + R[1][2] * Z + T[1]
        zp = R[2][0] * X + R[2][1] * Y + R[2][2] * Z + T[2]
        zp = torch.where(zp == 0, tiny, zp)
        u, v = xp / zp, yp / zp
        r2 = u * u + v * v
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        ud = u * radial + (2 * p1) * u * v + p2 * (r2 + 2 * u * u)
        vd = v * radial + p1 * (r2 + 2 * v * v) + (2 * p2) * u * v
        xi = to_int32(float(pK[0, 0]) * ud + float(pK[0, 2]))  # truncated (:50)
        yi = to_int32(float(pK[1, 1]) * vd + float(pK[1, 2]))
        inside = (yi - w > 0) & (yi + w < Hp) & (xi - w > 0) & (xi + w < Wp)  # :54-59
        a = (xi * Hp + yi).to(dt) * _f32(inv_n)
        return torch.where(inside, base - (2.0 * a) * S1 + (K * a) * a, oob)

    diff = (depth0 * depth0) * float(np.float32(1.0) / np.float32(ref.p03))  # :110
    lo, hi = depth0 - diff, depth0 + diff
    inv_iters = float(np.float32(1.0) / np.float32(iters))

    def grid(center, radius):
        # iters + 1 samples from center - radius, clamped to [lo, hi]; the
        # first minimum wins
        step = (2.0 * radius) * inv_iters
        best_cost = torch.full_like(center, torch.inf)
        best = center
        start = center - radius
        for i in range(iters + 1):
            x = torch.clamp(start + float(i) * step, lo, hi)
            f = cost(x)
            better = f < best_cost
            best_cost = torch.where(better, f, best_cost)
            best = torch.where(better, x, best)
        return best, step

    coarse, step = grid(depth0, diff)
    fine, _ = grid(coarse, step)
    ys = torch.arange(H, device=cam.device)[:, None]
    xs = torch.arange(W, device=cam.device)[None, :]
    region = (ys >= ws) & (ys < H - ws) & (xs >= ws) & (xs < W - ws)  # :107-108
    return torch.where((depth0 > 0) & region, fine, 0.0)


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[y + dy, x + dx], 0 where that is outside."""
    out = torch.zeros_like(a)
    H, W = a.shape
    out[max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = (
        a[max(dy, 0):H - max(-dy, 0), max(dx, 0):W - max(-dx, 0)])
    return out


def bilateral(img: torch.Tensor, d: int, sigma_color: float, sigma_space: float):
    """cv2.bilateralFilter(img, d, sigma_color, sigma_space), edges replicated."""
    H, W = img.shape
    r = d // 2
    padded = F.pad(img[None, None].float(), (r, r, r, r), mode="replicate")[0, 0].to(img.dtype)
    full = lambda v: torch.full((), v, dtype=img.dtype, device=img.device)  # noqa: E731
    sc, ss = full(sigma_color), full(sigma_space)
    inv2sc = full(1.0) / (2.0 * sc * sc)
    inv2ss = full(1.0) / (2.0 * ss * ss)
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            q = padded[r + dy:r + dy + H, r + dx:r + dx + W]
            diff = q - img
            wgt = torch.exp(-(diff * diff) * inv2sc - (dy * dy + dx * dx) * inv2ss)
            num = num + wgt * q
            den = den + wgt
    return num / den


def tv_denoise(y: torch.Tensor, mu: float, eps: float, niter: int, niter_inner: int):
    """min_u mu/2 |u - y|^2 + eps (|grad_x u|_1 + |grad_y u|_1) by split
    Bregman, penalty 2 eps; departure (B): each inner solve of
    (mu + lam grad^T grad) u = mu y - lam div(d - b) is ``niter_inner``
    Jacobi sweeps."""
    mu = torch.full((), mu, dtype=y.dtype, device=y.device)
    eps = torch.full((), eps, dtype=y.dtype, device=y.device)
    lam = 2.0 * eps
    thresh = eps / lam
    diag = mu + 4.0 * lam

    def shrink(v):
        return torch.sign(v) * torch.clamp_min(torch.abs(v) - thresh, 0.0)

    u = y
    dx, dy, bx, by = (torch.zeros_like(y) for _ in range(4))
    for _ in range(niter):
        px, py = dx - bx, dy - by
        div = (_shift(px, 0, 1) - px) + (_shift(py, 1, 0) - py)
        rhs = mu * y - lam * div
        for _ in range(niter_inner):
            neigh = _shift(u, 0, 1) + _shift(u, 0, -1) + _shift(u, 1, 0) + _shift(u, -1, 0)
            u = (rhs + lam * neigh) / diag
        gx = u - _shift(u, 0, -1)
        gy = u - _shift(u, -1, 0)
        dx, dy = shrink(gx + bx), shrink(gy + by)
        bx = bx + gx - dx
        by = by + gy - dy
    return u
