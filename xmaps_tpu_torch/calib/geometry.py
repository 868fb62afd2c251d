"""Camera geometry primitives: rotations, distortion, undistortion, LUTs.

Pure NumPy, bit-exact against the OpenCV routines the reference calls at
init (cam_proj_calibration.py:31-41,224-270).  The Brown-Conrady distortion
model with coefficients (k1, k2, p1, p2, k3[, k4, k5, k6]) is supported;
that covers both calibration dialects shipped with the reference
(5-coefficient vectors in data/*.yaml).

All of this executes once per session on the host; nothing here is traced
by JAX.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "rodrigues",
    "distort_points",
    "undistort_points",
    "init_undistort_rectify_map",
    "init_undistort_rectify_map_inverse",
]


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Convert a rotation vector to a matrix or a matrix to a vector.

    Matches cv2.Rodrigues for the conversions used in rectification.
    """
    r = np.asarray(r, dtype=np.float64)
    if r.shape in ((3,), (3, 1), (1, 3)):
        rv = r.reshape(3)
        theta = float(np.linalg.norm(rv))
        if theta < 1e-30:
            return np.eye(3)
        k = rv / theta
        K = np.array(
            [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]],
            dtype=np.float64,
        )
        return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)
    if r.shape == (3, 3):
        R = r
        A = (R - R.T) * 0.5
        rho = np.array([A[2, 1], A[0, 2], A[1, 0]])
        s = float(np.linalg.norm(rho))
        c = float(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0))
        if s < 1e-30:
            if c > 0:
                return np.zeros(3)
            # theta == pi: extract axis from R + I
            V = R + np.eye(3)
            v = V[:, int(np.argmax(np.sum(V * V, axis=0)))]
            u = v / np.linalg.norm(v)
            rv = u * np.pi
            # canonical sign
            if (rv[0] < 0) or (rv[0] == 0 and rv[1] < 0) or (
                rv[0] == 0 and rv[1] == 0 and rv[2] < 0
            ):
                rv = -rv
            return rv
        theta = float(np.arctan2(s, c))
        return rho / s * theta
    raise ValueError(f"rodrigues: unsupported shape {r.shape}")


def _full_dist(dist: np.ndarray) -> np.ndarray:
    d = np.zeros(8, dtype=np.float64)
    dist = np.asarray(dist, dtype=np.float64).reshape(-1)
    if dist.size not in (0, 4, 5, 8):
        raise ValueError(f"unsupported distortion vector of length {dist.size}")
    d[: dist.size] = dist
    return d


def distort_points(pts_norm: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Apply the Brown-Conrady model to normalized image points (..., 2)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _full_dist(dist)
    x = pts_norm[..., 0]
    y = pts_norm[..., 1]
    r2 = x * x + y * y
    radial = (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2) / (
        1.0 + ((k6 * r2 + k5) * r2 + k4) * r2
    )
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def undistort_points(
    pts: np.ndarray,
    K: np.ndarray,
    dist: np.ndarray,
    R: np.ndarray | None = None,
    P: np.ndarray | None = None,
    iterations: int = 5,
) -> np.ndarray:
    """Undistort pixel points; bit-exact vs cv2.undistortPoints.

    OpenCV's compensation loop runs exactly 5 fixed-point iterations of

        x <- (x0 - dx(x, y)) * icdist(r2)

    (verified empirically against cv2 5.0 to 1e-16; see
    tests/test_calib_vs_opencv.py).  Mirrors the reference usage at
    cam_proj_calibration.py:38.

    Args:
        pts: (..., 2) pixel coordinates.
        K: 3x3 intrinsic matrix.
        dist: distortion coefficients (4/5/8-vector or empty).
        R: optional 3x3 rectification rotation.
        P: optional 3x3 or 3x4 new projection matrix.

    Returns:
        (..., 2) points; normalized coordinates if P is None, else pixels.
    """
    pts = np.asarray(pts, dtype=np.float64)
    K = np.asarray(K, dtype=np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6 = _full_dist(dist)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    x = (pts[..., 0] - cx) / fx
    y = (pts[..., 1] - cy) / fy
    x0, y0 = x.copy(), y.copy()
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = (1.0 + ((k6 * r2 + k5) * r2 + k4) * r2) / (
            1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
        )
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist

    pn = np.stack([x, y, np.ones_like(x)], axis=-1)
    if R is not None:
        pn = pn @ np.asarray(R, dtype=np.float64).T
    pn = pn[..., :2] / pn[..., 2:3]
    if P is not None:
        P = np.asarray(P, dtype=np.float64)
        u = pn[..., 0] * P[0, 0] + P[0, 2]
        v = pn[..., 1] * P[1, 1] + P[1, 2]
        pn = np.stack([u, v], axis=-1)
    return pn


def init_undistort_rectify_map(
    K: np.ndarray,
    dist: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    size: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    """Forward rectification LUT: rectified pixel -> source pixel (f32).

    Equivalent of cv2.initUndistortRectifyMap with CV_32FC1 maps
    (reference: cam_proj_calibration.py:224-244).  For every pixel (u, v) of
    the rectified image: unproject through P, rotate by R^-1, distort, and
    project through K.

    Args:
        size: (width, height) of the rectified image.

    Returns:
        (map_x, map_y), each (H, W) float32 arrays of source coordinates.
    """
    W, H = size
    K = np.asarray(K, dtype=np.float64)
    P = np.asarray(P, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)

    u = np.arange(W, dtype=np.float64)
    v = np.arange(H, dtype=np.float64)
    uu, vv = np.meshgrid(u, v)
    x = (uu - P[0, 2]) / P[0, 0]
    y = (vv - P[1, 2]) / P[1, 1]

    iR = np.linalg.inv(R)
    pts = np.stack([x, y, np.ones_like(x)], axis=-1) @ iR.T
    pn = pts[..., :2] / pts[..., 2:3]
    pd = distort_points(pn, dist)
    map_x = (pd[..., 0] * K[0, 0] + K[0, 2]).astype(np.float32)
    map_y = (pd[..., 1] * K[1, 1] + K[1, 2]).astype(np.float32)
    return map_x, map_y


def init_undistort_rectify_map_inverse(
    K: np.ndarray,
    dist: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    size: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    """Inverse rectification LUT: source pixel -> rectified pixel (f32).

    Equivalent of the reference's initUndistortRectifyMapInverse
    (cam_proj_calibration.py:31-41): undistort every source pixel and
    project into the rectified frame.  The reference casts the meshgrid to
    float32 before undistorting; we mirror that for bit parity.

    Args:
        size: (width, height) of the *source* (camera/projector) image.

    Returns:
        (map_x, map_y), each (H, W) float32: rectified coords per src pixel.
    """
    W, H = size
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    coords = np.stack([xs, ys], axis=-1).astype(np.float32).astype(np.float64)
    pts = undistort_points(coords, K, dist, R=R, P=P)
    return pts[..., 0].astype(np.float32), pts[..., 1].astype(np.float32)
