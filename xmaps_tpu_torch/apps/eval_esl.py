"""ESL baseline (init + refined) for the offline evaluation, in PyTorch.

Port of ``xmaps_tpu.apps.eval_esl``: the reference's vendored ESL pipeline
(eval/compute_depth_esl.py, from uzh-rpg/ESL) as dense tensor programs
whose outputs play the same roles (esl/depth_init and the refined
esl/depth_optim_filtered pseudo-ground-truth read by the evaluation table).

- ``disparity_init`` (reference :72-85): per nonzero rectified camera
  pixel, a row-wise nearest-time search over columns [c+5, c+900).  The
  brute force ``disparity_init_dense`` is a loop over the 895 shifts; the
  fast path (``build_device_depth_init``) rectifies the scan with kernel B,
  binary-searches the camera footprint with kernel A and gathers back with
  kernel B, bit-identical to the brute force on monotone projector rows.
- ``depth_optimization`` (reference :104-129): a bounded two-level grid
  search of the closed-form patch cost (see the JAX package's docstring),
  one launch of kernel R on the card (``ops.esl_refine``).
- bilateral + split-Bregman TV denoise (reference :242-247) via
  ``utils.denoise``.

``main`` runs the sequence's scans through ``models.esl_pipeline``'s
``ESLDepthEngine.process_scans``, ``GROUP_SCANS`` (12) at a time.  Every entry
point runs on an explicit device: ``-device cuda`` (the default) needs a
card, ``-device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from xmaps_tpu_torch.ops.esl_refine import constant_block, esl_refine

MIN_DISP = 5  # reference eval/compute_depth_esl.py:75
MAX_DISP = 900


def disparity_init_dense(cam_rect, proj_rect, min_disp=MIN_DISP, max_disp=MAX_DISP):
    """Row-wise nearest-time disparity search (reference :72-85), dense.

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
    """Per-pixel statics for the analytic refinement cost.

    cost^2(rho) = C0 - 2 * a(rho) * S1 + K * a(rho)^2       (in-bounds)
    where a = (trunc(x_proj) * Hp + trunc(y_proj)) / (Wp * Hp) is the
    projector scan time at the reprojected pixel and C0/S1 are stencil
    sums of the camera image.
    """

    def __init__(self, calib_params, maps, window_size: int, proj_w: int, proj_h: int):
        from xmaps_tpu_torch.calib.geometry import undistort_points

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
    depth_optimization, :104-129), on depth_init's device: of one (H, W)
    scan, or of each scan of an (F, H, W) group (``cam_image`` the same
    shape, taken to that device), each scan of a group bit-equal to its
    one-scan call.  ``ops.esl_refine.esl_refine``: one launch of kernel R on
    the card, the plain version (a two-level grid search of the closed-form
    window cost, ``esl_refine_plain``) on the CPU."""
    depth0 = torch.as_tensor(depth_init, dtype=torch.float32)
    cam = torch.as_tensor(cam_image, dtype=torch.float32).to(depth0.device)
    return esl_refine(depth0.contiguous(), cam.contiguous(), plan, iters)


def normalize_scan(cam_image: np.ndarray) -> np.ndarray:
    """Reference :205-209: normalize nonzero values to [0, 1], clamp
    negatives (i.e. former zeros) to 0."""
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


def build_device_depth_init(
    maps, calib, proj_rect, p03, device,
    allow_banded: bool = True,
    remap_method: str = "auto",
):
    """The per-scan depth-init program on ``device``, cropped to the
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

    ``allow_banded`` and ``remap_method`` choose TPU schedules in the JAX
    package; here both remaps are kernel B whatever they say.

    Returns ``device_depth_init(cam_norm) -> (disp_cam, depth)``, float32
    (cam_h, cam_w) tensors on ``device`` for a float32 scan on ``device``;
    its ``disparity(cam_norm)`` gives ``disp_cam`` alone.
    """
    from xmaps_tpu_torch.ops.esl_search import (
        box_search_args,
        esl_search_box,
        esl_search_prep,
        footprint_box,
    )
    from xmaps_tpu_torch.ops.remap import (
        apply_remap_static,
        build_remap_indices,
        prepare_remap_static,
        upload,
    )

    del allow_banded
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
        method=remap_method,
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
    from xmaps_tpu_torch.calib.maps import remap_nearest

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


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="ESL depth baseline (init + refined), PyTorch/CUDA"
    )
    parser.add_argument("-object_dir", type=str, default="")
    parser.add_argument("-proj_height", type=int, default=1920)
    parser.add_argument("-proj_width", type=int, default=1080)
    parser.add_argument("-calib", type=str, default="")
    parser.add_argument("-w", type=int, default=3, help="Window size")
    parser.add_argument("-num_scans", type=int, default=60)
    parser.add_argument("-start_scan", type=int, default=0)
    parser.add_argument("-cam_width", type=int, default=640)
    parser.add_argument("-cam_height", type=int, default=480)
    parser.add_argument(
        "-skip_refine", action="store_true",
        help="Only compute depth_init (skip optimization + denoise)",
    )
    parser.add_argument(
        "-no_fast_search", action="store_true",
        help="Disable the binary-search kernel (use the dense brute-force "
        "disparity scan)",
    )
    parser.add_argument(
        "-device", choices=("cuda", "cpu"), default="cuda",
        help="cuda: the CUDA kernels (needs a card); cpu: their plain versions",
    )
    args = parser.parse_args(argv)

    from xmaps_tpu_torch.calib.maps import CalibrationParams
    from xmaps_tpu_torch.models.depth_pipeline import resolve_device
    from xmaps_tpu_torch.models import esl_pipeline

    dev = resolve_device(args.device)
    esl_dir = os.path.join(args.object_dir, "esl")
    dirs = {
        name: os.path.join(esl_dir, name)
        for name in ("disparity_init", "depth_init", "depth_optim", "depth_optim_filtered")
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    calib = CalibrationParams.from_esl_yaml(
        args.calib,
        camera_width=args.cam_width,
        camera_height=args.cam_height,
        projector_width=args.proj_width,
        projector_height=args.proj_height,
        rectification_scale=3.0,
    )

    scan_files = sorted(glob.glob(os.path.join(args.object_dir, "scans_np", "*.npy")))
    if not scan_files:
        print(f"No camera files found in {args.object_dir}/scans_np/!")
        return 1
    print(f"Found {len(scan_files)} scans!")

    # The fast init (kernels A and B) needs monotone projector rows (true
    # for the rectified ramp); the brute force is bit-identical.
    engine = esl_pipeline.ESLDepthEngine.from_calibration(
        calib, dev, window_size=args.w, fast_search=not args.no_fast_search,
        maps_cache_dir=os.path.expanduser("~/.cache/xmaps_tpu_torch"),
    )

    def run(group):
        """ESL's planes of a group of (index, scan), each saved as a file."""
        t0 = time.time()
        planes = engine.process_scans([scan for _, scan in group], refine=not args.skip_refine)
        first, last = group[0][0], group[-1][0]
        print(f"Completed scans {first}-{last} ({len(group)}) in time {time.time() - t0}")
        for name, plane in zip(planes._fields, planes):
            if plane is None:
                continue
            for (i, _), a in zip(group, plane.numpy()):
                np.save(os.path.join(dirs[name], f"scans{str(i).zfill(3)}.npy"), a)

    group = []
    for i in range(args.start_scan, min(args.start_scan + args.num_scans, len(scan_files))):
        cam_raw = np.load(scan_files[i])
        if np.count_nonzero(cam_raw) == 0:
            print(f"Skip camera npy file {scan_files[i]} since it is empty")
            continue
        print(f"Processing frame: {i}, camera npy file {scan_files[i]}")
        group.append((i, cam_raw))
        if len(group) == esl_pipeline.GROUP_SCANS:
            run(group)
            group = []
    if group:
        run(group)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
