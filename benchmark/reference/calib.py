"""The rig's host calibration math, in NumPy: the plain reference's own copy.

A frozen copy of the formulas the reference pipeline needs (OpenCV's
``stereoRectify`` with ``alpha=-1`` and ``CALIB_ZERO_DISPARITY``,
``undistortPoints``' five fixed-point iterations, the inverse
rectification LUTs, the projector's linear scan time map and its
nearest-neighbour remap into the rectified frame; X-maps'
``cam_proj_calibration.py`` and ``proj_time_map.py``).  It imports nothing
of the system under test.

``rig_tables(rig)`` returns what the reference derives from the
calibration: the int16 camera and projector LUTs (source pixel ->
rectified pixel), the rectified projector time map and ``p03`` (P2[0, 3],
baseline x focal length).
"""

from __future__ import annotations

import numpy as np


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Rotation vector <-> matrix (cv2.Rodrigues), for the two cases used."""
    r = np.asarray(r, dtype=np.float64)
    if r.shape in ((3,), (3, 1), (1, 3)):
        rv = r.reshape(3)
        theta = float(np.linalg.norm(rv))
        if theta < 1e-30:
            return np.eye(3)
        k = rv / theta
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)
    A = (r - r.T) * 0.5
    rho = np.array([A[2, 1], A[0, 2], A[1, 0]])
    s = float(np.linalg.norm(rho))
    c = float(np.clip((np.trace(r) - 1.0) * 0.5, -1.0, 1.0))
    if s < 1e-30:
        if c > 0:
            return np.zeros(3)
        raise ValueError("rotation by pi is not used by these rigs")
    return rho / s * float(np.arctan2(s, c))


def _dist8(dist) -> np.ndarray:
    d = np.zeros(8)
    dist = np.asarray(dist, dtype=np.float64).reshape(-1)
    d[: dist.size] = dist
    return d


def distort_points(pts_norm: np.ndarray, dist) -> np.ndarray:
    """Brown-Conrady distortion of normalized points (..., 2)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist8(dist)
    x, y = pts_norm[..., 0], pts_norm[..., 1]
    r2 = x * x + y * y
    radial = (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1.0 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_points(pts, K, dist, R=None, P=None) -> np.ndarray:
    """cv2.undistortPoints: five fixed-point iterations, then R and P."""
    pts = np.asarray(pts, dtype=np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist8(dist)
    x = (pts[..., 0] - K[0, 2]) / K[0, 0]
    y = (pts[..., 1] - K[1, 2]) / K[1, 1]
    x0, y0 = x.copy(), y.copy()
    for _ in range(5):
        r2 = x * x + y * y
        icdist = (1.0 + ((k6 * r2 + k5) * r2 + k4) * r2) / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    pn = np.stack([x, y, np.ones_like(x)], axis=-1)
    if R is not None:
        pn = pn @ np.asarray(R, dtype=np.float64).T
    pn = pn[..., :2] / pn[..., 2:3]
    if P is not None:
        pn = np.stack([pn[..., 0] * P[0, 0] + P[0, 2], pn[..., 1] * P[1, 1] + P[1, 2]], axis=-1)
    return pn


def stereo_rectify(K1, D1, K2, D2, size, R, T):
    """cv2.stereoRectify(alpha=-1, CALIB_ZERO_DISPARITY) -> (R1, R2, P2);
    OpenCV stages the corner points through float32, and so does this."""
    R = np.asarray(R, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64).reshape(3)
    nx, ny = size
    r_r = rodrigues(rodrigues(R) * -0.5)
    t_half = r_r @ T
    idx = 0 if abs(t_half[0]) > abs(t_half[1]) else 1
    c = t_half[idx]
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t_half, uu)
    nw = float(np.linalg.norm(ww))
    if nw > 0.0:
        ww *= float(np.arccos(abs(c) / float(np.linalg.norm(t_half)))) / nw
    wR = rodrigues(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T
    fc = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * 0.5
    corners = np.array([[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]], dtype=np.float64)
    cc = np.zeros((2, 2))
    for k, (A, Dk, Rk) in enumerate(((K1, D1, R1), (K2, D2, R2))):
        und = undistort_points(corners.astype(np.float32).astype(np.float64), A, Dk)
        ph = np.concatenate([und.astype(np.float32).astype(np.float64), np.ones((4, 1))], axis=1)
        ph = ph.astype(np.float32).astype(np.float64) @ Rk.T
        proj = (ph[:, :2] / ph[:, 2:3] * fc).astype(np.float32).astype(np.float64)
        avg = proj.mean(axis=0)
        cc[k] = [(nx - 1) / 2 - avg[0], (ny - 1) / 2 - avg[1]]
    cx, cy = (cc[0] + cc[1]) * 0.5
    P = np.array([[fc, 0, cx, 0], [0, fc, cy, 0], [0, 0, 1, 0]], dtype=np.float64)
    P2 = P.copy()
    P2[idx, 3] = t[idx] * fc
    return R1, R2, P, P2


def forward_map(K, dist, R, P, size):
    """cv2.initUndistortRectifyMap (CV_32FC1): rectified px -> source px."""
    W, H = size
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    pts = np.stack([(uu - P[0, 2]) / P[0, 0], (vv - P[1, 2]) / P[1, 1], np.ones_like(uu)], axis=-1)
    pts = pts @ np.linalg.inv(R).T
    pd = distort_points(pts[..., :2] / pts[..., 2:3], dist)
    return ((pd[..., 0] * K[0, 0] + K[0, 2]).astype(np.float32),
            (pd[..., 1] * K[1, 1] + K[1, 2]).astype(np.float32))


def inverse_map_i16(K, dist, R, P, size):
    """Source px -> rectified px, float32 then rint to int16 (X-maps'
    initUndistortRectifyMapInverse and mapf_to_i16)."""
    W, H = size
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    coords = np.stack([xs, ys], axis=-1).astype(np.float32).astype(np.float64)
    pts = undistort_points(coords, K, dist, R=R, P=P)
    out = []
    for a in (pts[..., 0].astype(np.float32), pts[..., 1].astype(np.float32)):
        a = np.rint(a)
        if a.min() < -32768 or a.max() > 32767:
            raise ValueError("a rectification LUT leaves the int16 range")
        out.append(a.astype(np.int16))
    return out


def linear_time_map(width: int, height: int) -> np.ndarray:
    """The projector's scan time of each pixel in [0, 1): column-major,
    each column scanned bottom to top (proj_time_map.py:6-19)."""
    ys, xs = np.mgrid[0:height, 0:width]
    return ((xs * height + ys[::-1]) / (width * height)).astype(np.float32)


def remap_nearest_constant(img, map_x, map_y) -> np.ndarray:
    """cv2.remap(INTER_NEAREST, BORDER_CONSTANT 0): the float32 maps
    rounded half to even."""
    H, W = img.shape
    xi = np.rint(map_x).astype(np.int64)
    yi = np.rint(map_y).astype(np.int64)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    return np.where(inb, img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)], 0).astype(img.dtype)


def rig_tables(rig: dict) -> dict:
    """The reference's tables of a rig (a configuration's ``rig`` block).

    The projector is the first view of the stereo pair, as in X-maps; R1
    rectifies the camera and R2 the projector whichever view comes first.
    """
    cam = (rig["camera_width"], rig["camera_height"])
    proj = (rig["projector_width"], rig["projector_height"])
    rect = (rig["rect_width"], rig["rect_height"])
    Kc, Dc = np.array(rig["camera_K"]), np.array(rig["camera_D"])
    Kp, Dp = np.array(rig["projector_K"]), np.array(rig["projector_D"])
    R1, R2, P1, P2 = stereo_rectify(Kp, Dp, Kc, Dc, rect, rig["cam2proj_R"], rig["cam2proj_T"])
    cam_x, cam_y = inverse_map_i16(Kc, Dc, R1, P1, cam)
    proj_x, proj_y = inverse_map_i16(Kp, Dp, R2, P2, proj)
    fx, fy = forward_map(Kp, Dp, R2, P2, rect)
    time_map = remap_nearest_constant(linear_time_map(*proj), fx, fy)
    return dict(cam_mapx=cam_x, cam_mapy=cam_y, proj_mapx=proj_x, proj_mapy=proj_y,
                time_map=time_map, p03=np.float64(P2[0, 3]))
