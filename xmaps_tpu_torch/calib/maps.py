"""Calibration parameter loading and rectification-LUT construction.

Host-side, one-time-per-session (reference: cam_proj_calibration.py:55-331,
proj_time_map.py).  Produces the plain-array bundle the device pipeline
consumes:

- forward LUTs (rectified -> camera/projector source pixel), used to rectify
  the projector time map at init;
- inverse LUTs (camera/projector pixel -> rectified pixel), f32 and i16;
  the i16 camera maps drive the per-event rectification gathers on device;
- the rectified projector time map (from the linear scan model or a
  precalibrated .npy);
- stereo geometry (R1, R2, P1, P2, Q).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from xmaps_tpu_torch.calib.cv_yaml import load_cv_yaml, read_cv_matrix
from xmaps_tpu_torch.calib.geometry import (
    init_undistort_rectify_map,
    init_undistort_rectify_map_inverse,
)
from xmaps_tpu_torch.calib.rectify import stereo_rectify
from xmaps_tpu_torch.config import RECTIFICATION_SCALE_ESL, RECTIFICATION_SCALE_XMAPS

__all__ = [
    "CalibrationParams",
    "CamProjMaps",
    "map_f32_to_i16",
    "generate_linear_projector_time_map",
    "remap_nearest",
]


def map_f32_to_i16(map_f32: np.ndarray) -> np.ndarray:
    """Quantize a float32 coordinate LUT to int16 with rint rounding.

    Mirrors mapf_to_i16 (reference: cam_proj_calibration.py:44-48) including
    the range assertion.
    """
    assert map_f32.dtype == np.float32
    map_i = np.rint(map_f32)
    info = np.iinfo(np.int16)
    assert map_i.min() >= info.min and map_i.max() <= info.max
    return map_i.astype(np.int16)


@dataclass
class CalibrationParams:
    """Loaded camera/projector calibration (reference:
    cam_proj_calibration.py:55-140)."""

    camera_width: int
    camera_height: int

    projector_width: int
    projector_height: int

    rect_image_width: int
    rect_image_height: int

    camera_K: np.ndarray
    camera_D: np.ndarray

    projector_K: np.ndarray
    projector_D: np.ndarray

    cam2proj_R: np.ndarray
    cam2proj_T: np.ndarray

    F: Optional[np.ndarray] = None

    @staticmethod
    def from_yaml(
        calibration_yaml_path: str,
        camera_width: int,
        camera_height: int,
        projector_width: int,
        projector_height: int,
        rectification_scale: float = RECTIFICATION_SCALE_XMAPS,
    ) -> "CalibrationParams":
        """Load the X-maps calibration dialect (cam_proj_calibration.py:77-108).

        The projector distortion coefficients are zeroed, and the rectified
        image is rectification_scale (2.75) times the camera size, as in the
        reference.
        """
        data = load_cv_yaml(calibration_yaml_path)
        F = None
        for key in ("F", "fundamental_matrix"):
            if key in data:
                F = read_cv_matrix(data, key)
                break
        return CalibrationParams(
            camera_width=camera_width,
            camera_height=camera_height,
            projector_width=projector_width,
            projector_height=projector_height,
            rect_image_width=round(camera_width * rectification_scale),
            rect_image_height=round(camera_height * rectification_scale),
            camera_K=read_cv_matrix(data, "camera_intrinsic_matrix"),
            camera_D=read_cv_matrix(data, "camera_distortion_coefficients"),
            projector_K=read_cv_matrix(data, "projector_intrinsic_matrix"),
            # Projector distortion is ignored in this dialect (reference
            # cam_proj_calibration.py:86-89).
            projector_D=np.zeros(5),
            cam2proj_R=read_cv_matrix(data, "relative_rotation"),
            cam2proj_T=read_cv_matrix(data, "relative_translation"),
            F=F,
        )

    @staticmethod
    def from_esl_yaml(
        calibration_yaml_path: str,
        camera_width: int,
        camera_height: int,
        projector_width: int,
        projector_height: int,
        rectification_scale: float = RECTIFICATION_SCALE_ESL,
    ) -> "CalibrationParams":
        """Load the ESL FileStorage dialect (cam_proj_calibration.py:110-140).

        Rectified image is rectification_scale (3.0) times the projector size.
        """
        data = load_cv_yaml(calibration_yaml_path)
        return CalibrationParams(
            camera_width=camera_width,
            camera_height=camera_height,
            projector_width=projector_width,
            projector_height=projector_height,
            rect_image_width=round(projector_width * rectification_scale),
            rect_image_height=round(projector_height * rectification_scale),
            camera_K=read_cv_matrix(data, "cam_K"),
            camera_D=read_cv_matrix(data, "cam_kc"),
            projector_K=read_cv_matrix(data, "proj_K"),
            projector_D=read_cv_matrix(data, "proj_kc"),
            cam2proj_R=read_cv_matrix(data, "R"),
            cam2proj_T=read_cv_matrix(data, "T"),
        )


def generate_linear_projector_time_map(
    proj_width: int, proj_height: int, scan_upwards: bool
) -> np.ndarray:
    """Linear scan model: column-major pixel index normalized to [0, 1).

    The projector scans column-by-column (x outer, y inner), optionally
    bottom-to-top (reference: proj_time_map.py:6-19).
    """
    ys, xs = np.mgrid[0:proj_height, 0:proj_width]
    if scan_upwards:
        ys = ys[::-1]
    pixel_indices = xs * proj_height + ys
    return (pixel_indices / (proj_width * proj_height)).astype(np.float32)


def remap_nearest(
    img: np.ndarray,
    map_x: np.ndarray,
    map_y: np.ndarray,
    border_replicate: bool,
) -> np.ndarray:
    """Nearest-neighbor remap, semantics of cv2.remap(INTER_NEAREST).

    OpenCV converts the float32 maps with round-half-to-even (verified
    empirically); BORDER_REPLICATE clamps, BORDER_CONSTANT yields 0.
    Used at init to rectify the projector time map
    (reference: proj_time_map.py:22-29).
    """
    H, W = img.shape[:2]
    xi = np.rint(map_x).astype(np.int64)
    yi = np.rint(map_y).astype(np.int64)
    xc = np.clip(xi, 0, W - 1)
    yc = np.clip(yi, 0, H - 1)
    out = img[yc, xc]
    if not border_replicate:
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = np.where(inb, out, np.zeros_like(out))
    return out


@dataclass
class CamProjMaps:
    """All rectification LUTs + stereo geometry (host arrays).

    Mirrors the reference CamProjMaps (cam_proj_calibration.py:143-270) with
    the same stereo ordering: by default the projector is the first camera
    of the pair (cam_is_left=False).
    """

    calib: CalibrationParams
    cam_is_left: bool = False
    zero_undistort_proj_map: bool = False

    R1: np.ndarray = field(init=False)
    R2: np.ndarray = field(init=False)
    P1: np.ndarray = field(init=False)
    P2: np.ndarray = field(init=False)
    Q: np.ndarray = field(init=False)

    # forward LUTs: rectified pixel -> source pixel (for remapping images
    # into rectified space)
    camera_mapx: np.ndarray = field(init=False)
    camera_mapy: np.ndarray = field(init=False)
    projector_mapx: np.ndarray = field(init=False)
    projector_mapy: np.ndarray = field(init=False)

    # inverse LUTs: source pixel -> rectified pixel (for per-event
    # rectification gathers and for remapping the rectified disparity map
    # back to the projector)
    disp_cam_mapx_f32: np.ndarray = field(init=False)
    disp_cam_mapy_f32: np.ndarray = field(init=False)
    disp_cam_mapx_i16: np.ndarray = field(init=False)
    disp_cam_mapy_i16: np.ndarray = field(init=False)
    disp_proj_mapx_i16: np.ndarray = field(init=False)
    disp_proj_mapy_i16: np.ndarray = field(init=False)

    _ARRAY_FIELDS = (
        "R1", "R2", "P1", "P2", "Q",
        "camera_mapx", "camera_mapy", "projector_mapx", "projector_mapy",
        "disp_cam_mapx_f32", "disp_cam_mapy_f32",
        "disp_cam_mapx_i16", "disp_cam_mapy_i16",
        "disp_proj_mapx_i16", "disp_proj_mapy_i16",
    )

    @staticmethod
    def build_cached(
        calib: CalibrationParams,
        cam_is_left: bool = False,
        zero_undistort_proj_map: bool = False,
        cache_dir: "str | None" = None,
    ) -> "CamProjMaps":
        """Build with a disk cache keyed by the calibration.

        The LUT build (stereo rectify + 5-iteration iterative undistort
        over the full rect grid) is pure host NumPy and costs ~10-17 s at
        the demonstrator rig -- the dominant WARM setup term
        (SETUP_r05.json).  The maps are a pure function of the
        calibration, so sessions reuse them like the X-map/tail-plan
        caches (SURVEY §5 checkpoint/resume analog).
        """
        import hashlib
        import os

        if not cache_dir:
            return CamProjMaps(calib, cam_is_left, zero_undistort_proj_map)
        h = hashlib.sha256()
        for a in (
            calib.camera_K, calib.camera_D, calib.projector_K,
            calib.projector_D, calib.cam2proj_R, calib.cam2proj_T,
        ):
            h.update(np.ascontiguousarray(np.asarray(a, np.float64)).tobytes())
        h.update(
            f"{calib.camera_width}|{calib.camera_height}|"
            f"{calib.projector_width}|{calib.projector_height}|"
            f"{calib.rect_image_width}|{calib.rect_image_height}|"
            f"{cam_is_left}|{zero_undistort_proj_map}|v1".encode()
        )
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(
            cache_dir, f"camprojmaps_{h.hexdigest()[:24]}.npz"
        )
        if os.path.exists(path):
            obj = object.__new__(CamProjMaps)
            obj.calib = calib
            obj.cam_is_left = cam_is_left
            obj.zero_undistort_proj_map = zero_undistort_proj_map
            with np.load(path) as z:
                for name in CamProjMaps._ARRAY_FIELDS:
                    setattr(obj, name, z[name])
            return obj
        maps = CamProjMaps(calib, cam_is_left, zero_undistort_proj_map)
        np.savez(
            path,
            **{n: getattr(maps, n) for n in CamProjMaps._ARRAY_FIELDS},
        )
        return maps

    def __post_init__(self):
        calib = self.calib
        if self.cam_is_left:
            K1, D1 = calib.camera_K, calib.camera_D
            K2, D2 = calib.projector_K, calib.projector_D
        else:
            K1, D1 = calib.projector_K, calib.projector_D
            K2, D2 = calib.camera_K, calib.camera_D

        rect_size = (calib.rect_image_width, calib.rect_image_height)
        self.R1, self.R2, self.P1, self.P2, self.Q = stereo_rectify(
            K1, D1, K2, D2, rect_size, calib.cam2proj_R, calib.cam2proj_T
        )

        # The extrinsics (R, T) always map camera coords to projector coords,
        # so R1 rectifies the camera frame and R2 the projector frame
        # regardless of cam_is_left -- cam_is_left only swaps which
        # intrinsics seed stereo_rectify's common focal/principal point.
        # Mirrors reference cam_proj_calibration.py:224-270.
        cam_R, cam_P = self.R1, self.P1
        proj_R, proj_P = self.R2, self.P2

        self.camera_mapx, self.camera_mapy = init_undistort_rectify_map(
            calib.camera_K, calib.camera_D, cam_R, cam_P, rect_size
        )

        # ESL compatibility: projector distortion optionally ignored here
        # though still used in stereo_rectify (cam_proj_calibration.py:233-234).
        proj_D = np.zeros(5) if self.zero_undistort_proj_map else calib.projector_D
        self.projector_mapx, self.projector_mapy = init_undistort_rectify_map(
            calib.projector_K, proj_D, proj_R, proj_P, rect_size
        )

        self.disp_cam_mapx_f32, self.disp_cam_mapy_f32 = (
            init_undistort_rectify_map_inverse(
                calib.camera_K,
                calib.camera_D,
                cam_R,
                cam_P,
                (calib.camera_width, calib.camera_height),
            )
        )
        self.disp_cam_mapx_i16 = map_f32_to_i16(self.disp_cam_mapx_f32)
        self.disp_cam_mapy_i16 = map_f32_to_i16(self.disp_cam_mapy_f32)

        proj_mapx_f32, proj_mapy_f32 = init_undistort_rectify_map_inverse(
            calib.projector_K,
            calib.projector_D,
            proj_R,
            proj_P,
            (calib.projector_width, calib.projector_height),
        )
        self.disp_proj_mapx_i16 = map_f32_to_i16(proj_mapx_f32)
        self.disp_proj_mapy_i16 = map_f32_to_i16(proj_mapy_f32)

    # -- projector time map ------------------------------------------------

    def build_rectified_time_map(
        self, scan_upwards: bool = True, border_replicate: bool = False
    ) -> np.ndarray:
        """Linear time map rectified into the rectified frame (f32, H_rect x
        W_rect).  Reference: proj_time_map.py:32-44.

        ``border_replicate`` defaults to False -- matching the reference's
        EXECUTED behavior, not its signature: remap_proj_time_map
        (proj_time_map.py:22-29) passes its border_mode into cv2.remap's
        positional ``dst`` slot, so the call always runs with the default
        BORDER_CONSTANT(0).  Out-of-projector rect pixels therefore stay
        t == 0, which the X-map build treats as undefined (x_map.py:41-42)
        -- the de-facto reference semantics every recorded result used.
        Pass True for the replicate behavior the reference's parameter
        name intended.  Pinned by tests/test_vs_reference.py.
        """
        tm = generate_linear_projector_time_map(
            self.calib.projector_width, self.calib.projector_height, scan_upwards
        )
        return remap_nearest(
            tm, self.projector_mapx, self.projector_mapy, border_replicate
        )

    # -- geometry helpers (used by eval / point clouds) ---------------------

    @property
    def depth_P(self) -> np.ndarray:
        """Projection matrix carrying the baseline term; depth = P[0,3]/disp
        (reference: disp_to_depth.py:46-63 uses P2)."""
        return self.P2

    def construct_point_cloud(
        self, xr_f32: np.ndarray, yr_f32: np.ndarray, disp_f32: np.ndarray
    ) -> np.ndarray:
        """Reproject rectified event coords + disparity through Q.

        Mirrors reference cam_proj_calibration.py:319-331 (projector-view
        points at x+disp, negated disparity, y/z axis flips).
        """
        n = len(xr_f32)
        pts = np.ones((n, 4), dtype=np.float32)
        pts[:, 0] = xr_f32 + disp_f32
        pts[:, 1] = yr_f32
        pts[:, 2] = -disp_f32
        pc = (self.Q.astype(np.float32) @ pts.T).T
        pc = (pc / pc[:, 3:])[:, :3]
        pc[:, 1] = -pc[:, 1]
        pc[:, 2] = -pc[:, 2]
        return pc
