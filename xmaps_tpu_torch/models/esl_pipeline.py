"""ESLDepthEngine: ESL's depth (the evaluation's pseudo-ground truth) over
groups of scans.

The X-maps evaluation (``eval/x-map-eval.sh`` -> ``compute_depth_esl.py``)
computes ESL's depth for every scan of a sequence and keeps four planes a
scan: the init's disparity and depth, the refined depth and the refined
depth filtered.  This engine runs that pipeline over F scans in one call,
on one device:

1. stage: each scan normalised on the host (``normalize_scan``) into one
   pinned buffer, then one host-to-device copy;
2. init (the reference's disparity_init, :72-85: a row-wise nearest-time
   search over columns [c+5, c+900) per lit rectified pixel), a scan at a
   time: kernel B into the camera's footprint box, kernel A's binary search,
   kernel B back (``build_device_depth_init``, bit-identical to the brute
   force on monotone projector rows), then the depth of the group's
   disparities at once (with ``fast_search=False``, or rows that are not
   monotone, the brute force ``depth_init_dense``, a loop over the 895
   shifts);
3. refine (the reference's depth_optimization, :104-129, as a bounded
   two-level grid search of the closed-form patch cost): the (F, H, W) stack
   at once (``depth_optimization_dense``: one launch of kernel R on the
   card), each scan's empty pixels filled with 1 / its pixel (0, 0) as the
   eval does;
4. denoise: the bilateral filter and the split-Bregman TV denoise over the
   stack (``ops.esl_denoise.esl_denoise``: 21 launches of kernel D on the
   card);
5. fetch: the planes into pinned host memory, then one synchronise.

Steps 3 and 4 issue the same launches whatever F is, and every scan of a
group is bit-equal to the one-scan calls of the same functions.  Each step
is a span of ``utils.stats`` inside ``esl.call`` (tagged with F).

The functions of steps 1-3 are the ports of ``xmaps_tpu.apps.eval_esl``'s
(the reference's vendored eval/compute_depth_esl.py, from uzh-rpg/ESL);
``apps.eval_esl`` is the CLI that runs a sequence through this engine.
"""

from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from xmaps_tpu_torch.calib.geometry import undistort_points
from xmaps_tpu_torch.calib.maps import CalibrationParams, CamProjMaps, remap_nearest
from xmaps_tpu_torch.models.depth_pipeline import resolve_device
from xmaps_tpu_torch.ops.esl_denoise import esl_denoise
from xmaps_tpu_torch.ops.esl_refine import constant_block, esl_refine
from xmaps_tpu_torch.ops.esl_search import (
    box_search_args,
    esl_search_box,
    esl_search_prep,
    footprint_box,
    rows_monotone,
)
from xmaps_tpu_torch.ops.remap import (
    apply_remap_static,
    build_remap_indices,
    prepare_remap_static,
    upload,
)
from xmaps_tpu_torch.utils.stats import span

__all__ = ["ESLDepthEngine", "ESLPlanes", "BILATERAL", "TV_DENOISE", "GROUP_SCANS", "MIN_DISP",
           "MAX_DISP", "disparity_init_dense", "RefinePlan", "depth_optimization_dense",
           "normalize_scan", "depth_from_disparity", "build_device_depth_init", "depth_init_dense"]

#: scans a call is built for: the pinned staging buffer's size at set-up
#: (grown if a call brings more), and the size of ``apps.eval_esl``'s groups
GROUP_SCANS = 12

#: the bilateral filter's arguments (compute_depth_esl.py:242)
BILATERAL = dict(d=5, sigma_color=3.0, sigma_space=3.0)
#: the TV denoise's arguments (esl_utilities.py:206-223)
TV_DENOISE = dict(mu=0.5, eps=0.1, niter=20, niter_inner=10)

MIN_DISP = 5  # reference eval/compute_depth_esl.py:75
MAX_DISP = 900


def disparity_init_dense(cam_rect, proj_rect, min_disp=MIN_DISP, max_disp=MAX_DISP):
    """Row-wise nearest-time disparity search (reference :72-85), dense
    (``xmaps_tpu.apps.eval_esl.disparity_init_dense``).

    For each pixel c of each row, among nonzero projector pixels at
    columns c+d, d in [min_disp, max_disp), pick the d minimizing
    (proj - cam)^2 (first minimum on ties, like np.argmin); require at
    least two nonzero candidates and a nonzero camera pixel.  Tensors (or
    NumPy, taken to the CPU) in, a float32 tensor on cam's device out.
    """
    cam = torch.as_tensor(cam_rect, dtype=torch.float32)
    proj = torch.as_tensor(proj_rect, dtype=torch.float32).to(cam.device)
    H, W = cam.shape
    proj_pad = torch.cat([proj, proj.new_zeros((H, max_disp))], 1)
    count = torch.zeros((H, W), dtype=torch.int32, device=cam.device)
    best_cost = torch.full((H, W), torch.inf, dtype=torch.float32, device=cam.device)
    best_d = torch.zeros((H, W), dtype=torch.int32, device=cam.device)
    for d in range(int(min_disp), int(max_disp)):
        shifted = proj_pad[:, d:d + W]
        valid = shifted != 0
        diff = shifted - cam
        cost = diff * diff
        better = valid & (cost < best_cost)
        count += valid
        best_cost = torch.where(better, cost, best_cost)
        best_d = torch.where(better, d, best_d)
    ok = (cam != 0) & (count > 1)
    return torch.where(ok, best_d, 0).float()


class RefinePlan:
    """Per-pixel statics for the analytic refinement cost
    (``xmaps_tpu.apps.eval_esl.RefinePlan``).

    cost^2(rho) = C0 - 2 * a(rho) * S1 + K * a(rho)^2       (in-bounds)
    where a = (trunc(x_proj) * Hp + trunc(y_proj)) / (Wp * Hp) is the
    projector scan time at the reprojected pixel and C0/S1 are stencil
    sums of the camera image.
    """

    def __init__(self, calib_params, maps, window_size: int, proj_w: int, proj_h: int):
        cam_K = calib_params.camera_K
        cam_D = calib_params.camera_D
        H, W = calib_params.camera_height, calib_params.camera_width
        xs, ys = np.meshgrid(np.arange(W), np.arange(H))
        pts = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)
        # reference :29-34: undistortPoints(P=cam_K), then normalize by K
        und = undistort_points(pts, cam_K, cam_D, R=None, P=cam_K)
        self.x_n = (
            (und[:, 0] - cam_K[0, 2]) / cam_K[0, 0]
        ).reshape(H, W).astype(np.float32)
        self.y_n = (
            (und[:, 1] - cam_K[1, 2]) / cam_K[1, 1]
        ).reshape(H, W).astype(np.float32)
        self.R = np.asarray(maps.calib.cam2proj_R, np.float32)
        self.T = np.asarray(maps.calib.cam2proj_T, np.float32).reshape(3)
        self.proj_K = np.asarray(calib_params.projector_K, np.float32)
        self.proj_D = np.asarray(calib_params.projector_D, np.float32)
        self.window_size = int(window_size)
        self.w = self.window_size // 2
        self.proj_w = int(proj_w)
        self.proj_h = int(proj_h)
        self.p03 = float(maps.P2[0, 3])
        self._rays = {}
        self._constants = {}

    def rays(self, device) -> tuple:
        """``(x_n, y_n)`` as float32 tensors on ``device``, uploaded at the
        first call for that device."""
        dev = torch.device(device)
        if dev not in self._rays:
            self._rays[dev] = (torch.from_numpy(self.x_n).to(dev),
                               torch.from_numpy(self.y_n).to(dev))
        return self._rays[dev]

    def constants(self, device, iters: int) -> torch.Tensor:
        """Kernel R's constant block (``ops.esl_refine.constant_block``) for
        ``iters`` as a float32 tensor on ``device``, built from the plan's
        fields at the first call for that device and ``iters``."""
        key = (torch.device(device), int(iters))
        if key not in self._constants:
            self._constants[key] = torch.from_numpy(constant_block(self, iters)).to(key[0])
        return self._constants[key]


def depth_optimization_dense(depth_init, cam_image, plan: RefinePlan, iters: int = 64):
    """Refinement of every defined depth pixel at once (reference
    depth_optimization, :104-129; ``xmaps_tpu.apps.eval_esl.
    depth_optimization_dense``), on depth_init's device: of one (H, W)
    scan, or of each scan of an (F, H, W) group (``cam_image`` the same
    shape, taken to that device), each scan of a group bit-equal to its
    one-scan call.  ``ops.esl_refine.esl_refine``: one launch of kernel R on
    the card, the plain version (a two-level grid search of the closed-form
    window cost, ``esl_refine_plain``) on the CPU."""
    depth0 = torch.as_tensor(depth_init, dtype=torch.float32)
    cam = torch.as_tensor(cam_image, dtype=torch.float32).to(depth0.device)
    return esl_refine(depth0.contiguous(), cam.contiguous(), plan, iters)


def normalize_scan(cam_image: np.ndarray) -> np.ndarray:
    """Reference :205-209 (``xmaps_tpu.apps.eval_esl.normalize_scan``):
    normalize nonzero values to [0, 1], clamp negatives (i.e. former zeros)
    to 0."""
    nz = cam_image != 0
    lo = cam_image[nz].min()
    hi = cam_image[nz].max()
    out = (cam_image - lo) / (hi - lo)
    out[out < 0] = 0
    return out.astype(np.float32)


def depth_from_disparity(disp: torch.Tensor, p03: float) -> torch.Tensor:
    """``where(disp != 0, p03 / disp, 0)`` in float32, as an IEEE quotient
    on either device (a tensor numerator: a Python scalar one would be a
    reciprocal multiply in PyTorch)."""
    return torch.where(disp != 0, torch.full_like(disp, p03) / disp, 0.0)


def build_device_depth_init(maps, calib, proj_rect, p03, device):
    """The per-scan depth-init program on ``device``
    (``xmaps_tpu.apps.eval_esl.build_device_depth_init``), cropped to the
    static camera footprint: forward remap (kernel B) -> binary search
    (kernel A) -> back-gather (kernel B) -> depth.

    The camera occupies a few percent of the 3x-projector rect surface,
    and that footprint is a pure function of the calibration: the forward
    remap's in-bounds mask bounds every possibly-nonzero cam_rect pixel,
    and the back-remap's target set bounds every rect position the
    camera-view gather reads.  Cropping the whole path to the union box is
    bit-identical to the full-surface brute force.  The box-sized static
    arrays (remap indices, the search's prep tables) are built once here
    and stay on the device.

    The JAX package's ``allow_banded`` and ``remap_method`` choose TPU
    schedules; here both remaps are kernel B.

    Returns ``device_depth_init(cam_norm) -> (disp_cam, depth)``, float32
    (cam_h, cam_w) tensors on ``device`` for a float32 scan on ``device``;
    its ``disparity(cam_norm)`` gives ``disp_cam`` alone.
    """
    dev = torch.device(device)
    H_r, W_r = calib.rect_image_height, calib.rect_image_width
    cam_shape = (calib.camera_height, calib.camera_width)
    yi_fwd, xi_fwd, inb_fwd = build_remap_indices(
        maps.camera_mapx, maps.camera_mapy, cam_shape
    )
    yi_b, xi_b, inb_b = build_remap_indices(
        maps.disp_cam_mapx_f32, maps.disp_cam_mapy_f32, (H_r, W_r)
    )
    occ_rows = np.nonzero(inb_fwd.any(axis=1))[0]
    occ_cols = np.nonzero(inb_fwd.any(axis=0))[0]
    rb = yi_b[inb_b]
    cb = xi_b[inb_b]
    if len(occ_rows) == 0 and len(rb) == 0:
        fp_rows = fp_cols = (0, 0)  # degenerate calibration
    else:
        lo_r = min(int(occ_rows[0]) if len(occ_rows) else 1 << 30,
                   int(rb.min()) if len(rb) else 1 << 30)
        hi_r = max(int(occ_rows[-1]) + 1 if len(occ_rows) else 0,
                   int(rb.max()) + 1 if len(rb) else 0)
        lo_c = min(int(occ_cols[0]) if len(occ_cols) else 1 << 30,
                   int(cb.min()) if len(cb) else 1 << 30)
        hi_c = max(int(occ_cols[-1]) + 1 if len(occ_cols) else 0,
                   int(cb.max()) + 1 if len(cb) else 0)
        fp_rows, fp_cols = (lo_r, hi_r), (lo_c, hi_c)
    r0, r1, c0, c1 = footprint_box((H_r, W_r), fp_rows, fp_cols)
    if r1 <= r0 or c1 <= c0:

        def empty_disparity(cam_norm):
            return torch.zeros(cam_shape, dtype=torch.float32, device=dev)

        def empty_depth_init(cam_norm):
            zero = empty_disparity(cam_norm)
            return zero, zero.clone()

        empty_depth_init.disparity = empty_disparity
        return empty_depth_init
    box_shape = (r1 - r0, c1 - c0)

    # the static inputs, cropped to the box once: the packed forward remap
    # index (the remap emits only the box), the search's prep tables, and
    # the packed box-relative back-gather index
    cfg_fwd, arrs_fwd = prepare_remap_static(
        yi_fwd[r0:r1, c0:c1], xi_fwd[r0:r1, c0:c1],
        inb_fwd[r0:r1, c0:c1], box_shape, cam_shape,
    )
    cfg_b, arrs_b = prepare_remap_static(
        yi_b.astype(np.int64) - r0, xi_b.astype(np.int64) - c0, inb_b,
        cam_shape, box_shape,
    )
    arrs_fwd, arrs_b = upload(arrs_fwd, dev), upload(arrs_b, dev)
    prep = esl_search_prep(
        torch.from_numpy(np.ascontiguousarray(proj_rect[r0:r1, c0:c1], np.float32)).to(dev),
        row_range=fp_rows, col_range=fp_cols, full_shape=(H_r, W_r),
    )
    # esl_disparity_search(..., full_shape=(H_r, W_r), emit_crop=True) on
    # the box, minus its argument checks
    search = box_search_args(W_r, c0, c1, MIN_DISP, MAX_DISP)

    def device_disparity(cam_norm):
        cam_box = apply_remap_static(cam_norm, arrs_fwd, cfg_fwd)
        disp_box = esl_search_box(cam_box, prep, **search)
        return apply_remap_static(disp_box, arrs_b, cfg_b)

    def device_depth_init(cam_norm):
        disp_cam = device_disparity(cam_norm)
        return disp_cam, depth_from_disparity(disp_cam, p03)

    device_depth_init.disparity = device_disparity

    #: the static device arrays and the box search's arguments, for
    #: measuring each stage and the tables' memory
    device_depth_init.bound = dict(forward=arrs_fwd, back=arrs_b, prep=prep, search=search)
    return device_depth_init


def depth_init_dense(cam_norm: np.ndarray, maps, proj_rect, p03, device):
    """The brute-force depth init (the ``-no_fast_search`` path and the
    oracle of the fast path): host remap into the rect frame, the dense
    search on ``device``, host remap back, host depth.  Returns NumPy
    (disparity, depth), float32."""
    cam_rect = remap_nearest(
        cam_norm, maps.camera_mapx, maps.camera_mapy, border_replicate=False
    )
    disparity_rect = disparity_init_dense(
        torch.from_numpy(np.ascontiguousarray(cam_rect, np.float32)).to(device),
        torch.from_numpy(np.ascontiguousarray(proj_rect, np.float32)).to(device),
    ).cpu().numpy()
    # rectified -> camera view (reference :218-222)
    disparity = remap_nearest(
        disparity_rect, maps.disp_cam_mapx_f32, maps.disp_cam_mapy_f32,
        border_replicate=False,
    ).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        depth = np.where(disparity != 0, p03 / disparity, 0.0).astype(np.float32)
    return disparity, depth



class ESLPlanes(NamedTuple):
    """A call's planes, each (F, H, W) float32 in the scans' order; the two
    refined planes are None where the call skipped the refinement."""

    disparity_init: torch.Tensor
    depth_init: torch.Tensor
    depth_optim: Optional[torch.Tensor]
    depth_optim_filtered: Optional[torch.Tensor]


class ESLDepthEngine:
    """ESL's depth pipeline bound to one calibration and one device; build
    with :meth:`from_calibration`, run with :meth:`process_scans`."""

    def __init__(self, maps: CamProjMaps, proj_rect: np.ndarray, plan: RefinePlan,
                 device: torch.device, depth_init, refine_iters: int):
        calib = maps.calib
        self.maps, self.proj_rect, self.plan = maps, proj_rect, plan
        self.p03 = float(maps.P2[0, 3])
        self.device = device
        #: ``build_device_depth_init``'s program, None for the brute force
        self.depth_init = depth_init
        self.refine_iters = int(refine_iters)
        self.shape = (calib.camera_height, calib.camera_width)
        self._host = self._host_buffer(GROUP_SCANS)
        #: the last host-to-device copy out of ``_host`` (CUDA only)
        self._copied = torch.cuda.Event() if device.type == "cuda" else None
        #: per-step wall-clock breakdown of the build, (label, seconds since
        #: the previous mark)
        self.setup_timings: list = []

    @property
    def fast_search(self) -> bool:
        """Whether the init runs kernels A and B (else the brute force)."""
        return self.depth_init is not None

    @staticmethod
    def from_calibration(
        calib: CalibrationParams,
        device,
        window_size: int = 7,
        refine_iters: int = 64,
        *,
        fast_search: bool = True,
        maps_cache_dir: Optional[str] = None,
    ) -> "ESLDepthEngine":
        """The engine of ``calib`` (an ESL rig: ``CalibrationParams.from_esl_yaml``'s
        rectified frame, 3x the projector) on ``device``, with the maps
        the evaluation uses (``CamProjMaps`` with the projector's
        distortion left out of its map), cached in ``maps_cache_dir``.
        Everything static is built once here, each step timed into
        ``setup_timings`` (on ``cuda`` each mark waits for the card first;
        ``XMAPS_SETUP_TRACE=1`` prints every mark to stderr): the footprint
        box, the two packed remap indices and the search's tables, the
        refinement's rays and constants on the device, and a pinned buffer for
        ``GROUP_SCANS`` scans."""
        trace = os.environ.get("XMAPS_SETUP_TRACE") == "1"
        t0 = time.perf_counter()
        timings: list = []
        prev = [t0]
        dev = resolve_device(device)

        def mark(label):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings.append((label, now - prev[0]))
            prev[0] = now
            if trace:
                print(f"[setup +{now - t0:7.2f}s] {label}", file=sys.stderr, flush=True)

        mark("device resolved (kernel library built or loaded)")
        maps = CamProjMaps.build_cached(calib, zero_undistort_proj_map=True,
                                        cache_dir=maps_cache_dir)
        mark("CamProjMaps (host calibration math, disk-cached)")
        # the analytic projector ramp, scanned downwards, rectified
        # (reference :96-101 + :201)
        proj_rect = maps.build_rectified_time_map(scan_upwards=False, border_replicate=False)
        mark("rectified projector time map")
        depth_init = None
        if fast_search and rows_monotone(proj_rect):
            depth_init = build_device_depth_init(maps, calib, proj_rect, float(maps.P2[0, 3]), dev)
        mark("init statics (footprint box, packed remap indices, search tables)")
        plan = RefinePlan(calib, maps, window_size, calib.projector_width,
                          calib.projector_height)
        plan.rays(dev)
        plan.constants(dev, refine_iters)
        mark("refinement plan (rays and kernel R's constants on the device)")
        eng = ESLDepthEngine(maps, proj_rect, plan, dev, depth_init, refine_iters)
        mark("pinned staging buffer")
        eng.setup_timings = timings
        return eng

    def _host_buffer(self, n: int) -> torch.Tensor:
        """A staging buffer for ``n`` scans: pinned for a CUDA engine."""
        return torch.empty((n, *self.shape), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def _stage(self, scans) -> tuple:
        """(the normalised scans on the host, the same on the device)."""
        n = len(scans)
        if self._copied is not None:
            self._copied.synchronize()  # the previous copy out of the buffer is done
        if n > len(self._host):
            self._host = self._host_buffer(n)
        host = self._host[:n]
        rows = host.numpy()
        for f, scan in enumerate(scans):
            scan = np.asarray(scan)
            if scan.shape != self.shape:
                raise ValueError(f"scan {f} is {scan.shape}, the camera {self.shape}")
            if not scan.any():
                raise ValueError(f"scan {f} is empty: its normalisation needs a lit pixel")
            rows[f] = normalize_scan(scan)
        if self._copied is None:
            return host, host
        cam = torch.empty(host.shape, dtype=torch.float32, device=self.device)
        cam.copy_(host, non_blocking=True)
        self._copied.record(torch.cuda.current_stream(self.device))
        return host, cam

    def _init(self, host: torch.Tensor, cam: torch.Tensor) -> tuple:
        """(disparity, depth) of the group, (F, H, W) on the device."""
        if self.depth_init is not None:
            disp = torch.stack([self.depth_init.disparity(c) for c in cam])
            return disp, depth_from_disparity(disp, self.p03)
        pairs = [depth_init_dense(c, self.maps, self.proj_rect, self.p03, self.device)
                 for c in host.numpy()]
        return tuple(torch.from_numpy(np.stack(p)).to(self.device) for p in zip(*pairs))

    def _fetch(self, planes: list) -> list:
        """The planes in one pinned host block, after one synchronise (a
        CPU engine's are already on the host)."""
        if self.device.type != "cuda":
            return planes
        out = torch.empty((len(planes), *planes[0].shape), dtype=torch.float32,
                          pin_memory=True)
        for dst, src in zip(out, planes):
            dst.copy_(src, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return list(out)

    def process_scans(self, scans, *, refine: bool = True, fetch: bool = True) -> ESLPlanes:
        """ESL's planes of F scans: a (F, H, W) array or a sequence of
        (H, W) arrays, each a camera's time map with 0 where the scan never
        reached and at least one lit pixel (as the evaluation loads them
        from ``scans_np/*.npy``).  ``refine=False`` stops after the init.
        ``fetch``: the planes in pinned host memory, the call's one
        synchronise (else on the device, nothing waited for)."""
        n = len(scans)
        if n == 0:
            raise ValueError("process_scans: no scans")
        with span("esl.call", n):
            with span("esl.stage"):
                host, cam = self._stage(scans)
            with span("esl.init"):
                planes = list(self._init(host, cam))
            if refine:
                with span("esl.refine"):
                    # reference :211: each scan's zeros -> 1 / its pixel (0, 0)
                    corner = cam[:, 0, 0]
                    fill = torch.ones_like(corner) / corner
                    img = torch.where(cam == 0, fill[:, None, None], cam)
                    optim = depth_optimization_dense(planes[1], img, self.plan,
                                                     self.refine_iters)
                with span("esl.denoise"):
                    filtered = esl_denoise(optim, **BILATERAL, **TV_DENOISE)
                planes += [optim, filtered]
            if fetch:
                with span("esl.fetch"):
                    planes = self._fetch(planes)
        return ESLPlanes(*planes, *[None] * (4 - len(planes)))
