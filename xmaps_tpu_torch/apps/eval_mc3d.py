"""MC3D baseline for the offline evaluation, in PyTorch.

Port of ``xmaps_tpu.apps.eval_mc3d``: the reference's vendored MC3D
per-pixel temporal correspondence baseline (eval/mc3d_baseline.py:40-78,
from uzh-rpg/ESL) as a dense tensor program.

Reference semantics, per nonzero camera pixel (i, j) of a median-blurred
time-surface scan:

1. (xc, yc) = trunc(inverse camera rectification map[i, j])   (:29-37)
2. proj_id = trunc(Wp * Hp * t);  proj_x = proj_id // Hp,
   proj_y = proj_id % Hp  (column-major unravel, :58-59)
3. search y in [proj_y - nc, proj_y + nc), nc = Hp // 15, for the
   candidate minimizing |yc - trunc(proj_inverse_map_y[y, proj_x])|; if
   the minimum is <= 50 rows and the disparity
   trunc(proj_inverse_map_x[y, proj_x]) - xc is positive, keep it (:60-75)

The window search is a loop over the 2*nc candidate rows, gathering
PY[y, proj_x] for every camera pixel at once and carrying the running
(min |yc - PY|, argmin y) with strict-less updates in ascending order:
np.argmin's first minimum, bit for bit.

Depth = P[0,3] / disparity with zero-preserve (:15-17), saved to
mc3d/depth/scansNNN.npy for the evaluation table.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

DIFF_Y_MAX = 50  # reference eval/mc3d_baseline.py:71


def build_mc3d_tables(calib, proj_w: int, proj_h: int, cam_w: int, cam_h: int):
    """Host-precomputed static tables (the reference's map setup, :108-113).

    Returns (xc, yc, PX, PY, p03, rect_size): truncated inverse rect maps
    for the camera grid, truncated inverse rect maps for the projector
    grid, and the depth scale.
    """
    from xmaps_tpu_torch.calib.geometry import (
        init_undistort_rectify_map_inverse,
    )
    from xmaps_tpu_torch.calib.rectify import stereo_rectify

    rect_size = (proj_w, proj_h)  # loadCalibParams(calib, proj_shape)
    R1, R2, P1, P2, Q = stereo_rectify(
        calib.projector_K,
        calib.projector_D,
        calib.camera_K,
        calib.camera_D,
        rect_size,
        calib.cam2proj_R,
        calib.cam2proj_T,
    )
    # camera: R1/P1 (first stereoRectify outputs -- reference e3d.R0/P0)
    cam_mx, cam_my = init_undistort_rectify_map_inverse(
        calib.camera_K, calib.camera_D, R1, P1, (cam_w, cam_h)
    )
    # projector: R2/P2 (reference e3d.R1/P1), WITH projector distortion
    proj_mx, proj_my = init_undistort_rectify_map_inverse(
        calib.projector_K, calib.projector_D, R2, P2, (proj_w, proj_h)
    )
    xc = cam_mx.astype(np.int32)  # int() truncation (reference :33-34)
    yc = cam_my.astype(np.int32)
    PX = proj_mx.astype(np.int32)  # (Hp, Wp)
    PY = proj_my.astype(np.int32)
    return xc, yc, PX, PY, float(P2[0, 3]), rect_size


def mc3d_disparity_dense(cam_image, tables, proj_w: int, proj_h: int) -> torch.Tensor:
    """Dense MC3D correspondence (reference compute_disparity, :40-78) on
    ``cam_image``'s device (a tensor; NumPy goes to the CPU).  ``tables``:
    the host arrays of :func:`build_mc3d_tables`."""
    from xmaps_tpu_torch.ops.esl_refine import to_int32_saturating

    xc_np, yc_np, PX_np, PY_np, _, _ = tables
    rect_w3, rect_h3 = proj_w * 3, proj_h * 3  # reference rectified_shape
    nc = proj_h // 15

    cam = torch.as_tensor(cam_image, dtype=torch.float32)
    dev = cam.device
    xc = torch.from_numpy(xc_np).to(dev)
    yc = torch.from_numpy(yc_np).to(dev)
    PXf = torch.from_numpy(np.ascontiguousarray(PX_np).reshape(-1)).to(dev)
    PYf = torch.from_numpy(np.ascontiguousarray(PY_np).reshape(-1)).to(dev)

    valid = cam > 0
    # reference :52-57: strict in-bounds of the rectified event coords
    valid &= (xc > 0) & (xc < rect_w3) & (yc > 0) & (yc < rect_h3)

    pid = to_int32_saturating(float(proj_w * proj_h) * cam)
    in_id = (pid >= 0) & (pid < proj_w * proj_h)  # unravel try/except (:73)
    pid_c = pid.clamp(0, proj_w * proj_h - 1)
    proj_x = torch.div(pid_c, proj_h, rounding_mode="floor")
    proj_y = pid_c - proj_x * proj_h
    valid &= in_id

    # windowed argmin of |yc - PY[y, proj_x]| over
    # y in [max(proj_y - nc, 0), min(proj_y + nc, proj_h))  (:60-71),
    # ascending with strict-less updates: the first minimum
    best_diff = torch.full(cam.shape, 1 << 30, dtype=torch.int32, device=dev)
    best_y = torch.zeros(cam.shape, dtype=torch.int32, device=dev)
    for k in range(2 * nc):
        y = proj_y + (k - nc)
        ok = (y >= 0) & (y < proj_h)
        d = torch.abs(yc - PYf[(y.clamp(0, proj_h - 1) * proj_w + proj_x).long()])
        upd = ok & (d < best_diff)
        best_diff = torch.where(upd, d, best_diff)
        best_y = torch.where(upd, y, best_y)

    px = PXf[(best_y.clamp(0, proj_h - 1) * proj_w + proj_x).long()]
    disp = px - xc
    ok = valid & (best_diff <= DIFF_Y_MAX) & (disp > 0)
    return torch.where(ok, disp, 0).float()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="MC3D temporal-correspondence baseline: per-scan depth "
        "maps for a camera+projector rig (PyTorch reimplementation)"
    )
    parser.add_argument("-object_dir", type=str, default="")
    parser.add_argument("-proj_height", type=int, default=1920)
    parser.add_argument("-proj_width", type=int, default=1080)
    parser.add_argument("-calib", type=str, default="")
    parser.add_argument("-num_scans", type=int, default=60)
    parser.add_argument("-start_scan", type=int, default=0)
    parser.add_argument("-cam_width", type=int, default=640)
    parser.add_argument("-cam_height", type=int, default=480)
    parser.add_argument(
        "-device", choices=("cuda", "cpu"), default="cuda",
        help="cuda: run on the card (needs one); cpu: on the host",
    )
    args = parser.parse_args(argv)

    from xmaps_tpu_torch.calib.maps import CalibrationParams
    from xmaps_tpu_torch.models.depth_pipeline import resolve_device
    from xmaps_tpu_torch.utils.denoise import median_blur_3x3

    dev = resolve_device(args.device)
    calib = CalibrationParams.from_esl_yaml(
        args.calib,
        camera_width=args.cam_width,
        camera_height=args.cam_height,
        projector_width=args.proj_width,
        projector_height=args.proj_height,
    )

    depth_dir = os.path.join(args.object_dir, "mc3d", "depth")
    os.makedirs(depth_dir, exist_ok=True)

    scan_files = sorted(glob.glob(os.path.join(args.object_dir, "scans_np", "*.npy")))
    if not scan_files:
        print("No camera files found!")
        return 1
    print(f"Found {len(scan_files)} scans!")

    tables = build_mc3d_tables(
        calib, args.proj_width, args.proj_height, args.cam_width, args.cam_height
    )
    p03 = tables[4]

    for k in range(args.start_scan, min(args.start_scan + args.num_scans, len(scan_files))):
        cam_image = np.load(scan_files[k])
        if np.count_nonzero(cam_image) == 0:
            print(f"Skip {k}")
            continue
        print(scan_files[k])
        t0 = time.time()
        blurred = median_blur_3x3(torch.from_numpy(cam_image.astype(np.float32)).to(dev))
        disparity = mc3d_disparity_dense(
            blurred, tables, args.proj_width, args.proj_height
        ).cpu().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = np.where(disparity != 0, p03 / disparity, 0.0).astype(np.float32)
        print(f"Completed frame {k} in time {time.time() - t0}")
        np.save(os.path.join(depth_dir, f"scans{str(k).zfill(3)}.npy"), depth)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
