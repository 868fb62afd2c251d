"""Offline eval: ESL-style time-surface scans -> depth maps + point clouds.

Port of ``xmaps_tpu.apps.eval_xmaps`` (the reference's
eval/compute_depth_x_maps.py): loads per-scan .npy time-surface images,
treats nonzero pixels as events with t = normalized intensity, and runs
the camera-view depth engine with the ESL compatibility modes
(zero_undistort_proj_map=True, scan_upwards=False, BORDER_CONSTANT).  A
scan is one batch of up to cam_w * cam_h events (307200 at 640 x 480):
kernel 1 (rectify, X-map gather, packed scatter) then kernel 3 (camera
view colorize) on the card.

Only the single-device path is ported: ``-devices N`` with N > 1 raises
(ROADMAP: multi-GPU).
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np


def scan_image_to_events(cam_image: np.ndarray):
    """Nonzero time-surface pixels -> float-t events
    (reference: eval/compute_depth_x_maps.py:82-96)."""
    nz = cam_image != 0
    if not nz.any():
        return None
    vals = cam_image[nz]
    lo, hi = vals.min(), vals.max()
    img = (cam_image - lo) / (hi - lo)
    img[img < 0] = 0
    pos = np.argwhere(img > 0)
    return {
        "x": pos[:, 1].astype(np.int64),
        "y": pos[:, 0].astype(np.int64),
        "t": img[img > 0].astype(np.float32),
        "p": np.ones(len(pos), dtype=np.int64),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Offline X-maps depth over ESL-style scan images "
        "(time-surface .npy per scan) in PyTorch/CUDA; flag-compatible with "
        "the reference eval entry point",
        formatter_class=argparse.RawTextHelpFormatter,
    )
    parser.add_argument("-object_dir", type=str, default="", help="Directory containing scans_np/*.npy")
    parser.add_argument("-proj_height", type=int, default=1920)
    parser.add_argument("-proj_width", type=int, default=1080)
    parser.add_argument("-calib", type=str, default="", help="ESL calibration yaml")
    parser.add_argument("-num_scans", type=int, default=60)
    parser.add_argument("-start_scan", type=int, default=0)
    parser.add_argument("-cam_width", type=int, default=640)
    parser.add_argument("-cam_height", type=int, default=480)
    parser.add_argument("-no_pointcloud", action="store_true")
    parser.add_argument(
        "-devices",
        type=int,
        default=1,
        help="Number of devices (0 = all available); only 1 is ported",
    )
    parser.add_argument(
        "-device", choices=("cuda", "cpu"), default="cuda",
        help="cuda: the CUDA kernels (needs a card); cpu: their plain versions",
    )
    args = parser.parse_args(argv)

    import torch

    from xmaps_tpu_torch.calib.maps import CalibrationParams
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.ops.disparity import compute_event_disparity
    from xmaps_tpu_torch.ops.event_batch import EventBatch
    from xmaps_tpu_torch.utils.ply import write_ply
    from xmaps_tpu_torch.utils.stats import SingleTimer

    n_dev = args.devices
    if n_dev == 0:
        n_dev = torch.cuda.device_count() if args.device == "cuda" else 1
    if n_dev > 1:
        raise NotImplementedError(
            f"-devices {n_dev}: scans on more than one device are not ported "
            "(ROADMAP.md: multi-GPU, data-parallel over frames)"
        )

    x_maps_dir = os.path.join(args.object_dir, "x_maps")
    depth_dir = os.path.join(x_maps_dir, "depth_init")
    pc_dir = os.path.join(x_maps_dir, "pointcloud_init")
    os.makedirs(depth_dir, exist_ok=True)
    os.makedirs(pc_dir, exist_ok=True)

    scan_files = sorted(glob.glob(os.path.join(args.object_dir, "scans_np", "*.npy")))
    if not scan_files:
        print(f"No camera files found in {args.object_dir}/scans_np/!")
        return 1
    print(f"Found {len(scan_files)} scans!")

    calib = CalibrationParams.from_esl_yaml(
        args.calib,
        camera_width=args.cam_width,
        camera_height=args.cam_height,
        projector_width=args.proj_width,
        projector_height=args.proj_height,
    )

    with SingleTimer("Setting up ESL-mode engine"):
        engine = XMapsDepthEngine.from_calibration(
            calib,
            device=args.device,
            event_capacity=args.cam_width * args.cam_height,
            camera_perspective=True,
            scan_upwards=False,
            border_replicate=False,
            zero_undistort_proj_map=True,
        )

    for i in range(args.start_scan, min(args.start_scan + args.num_scans, len(scan_files))):
        cam_image = np.load(scan_files[i])
        events = scan_image_to_events(cam_image)
        if events is None:
            print(f"Skip camera npy file {scan_files[i]} since it is empty")
            continue
        print(f"Processing frame: {i}, camera npy file {scan_files[i]}")

        batch = EventBatch.from_arrays(
            events["x"], events["y"], events["t"], events["p"],
            engine.cfg.event_capacity, device=engine.device,
        )
        t0 = time.time()
        out = engine.process_batch_device(batch)
        depth = out.depth.cpu().numpy()
        print(f"Completed disparity estimation: {i} in time {time.time() - t0}")
        np.save(os.path.join(depth_dir, f"scans{str(i).zfill(3)}.npy"), depth)

        if not args.no_pointcloud:
            # point cloud from rectified f32 coords of inliers
            # (reference compute_depth_x_maps.py:118-131)
            res = compute_event_disparity(
                batch,
                engine.tables.cam_mapx_i16,
                engine.tables.cam_mapy_i16,
                engine.tables.x_map,
                t_px_scale=engine.cfg.t_px_scale,
            )
            inlier = res.inlier.cpu().numpy()
            disp = res.disp.cpu().numpy()[inlier]
            xs = batch.x.cpu().numpy()[inlier]
            ys = batch.y.cpu().numpy()[inlier]
            xr_f32 = engine.maps.disp_cam_mapx_f32[ys, xs]
            yr_f32 = engine.maps.disp_cam_mapy_f32[ys, xs]
            pc = engine.maps.construct_point_cloud(xr_f32, yr_f32, disp)
            write_ply(os.path.join(pc_dir, f"scans{str(i).zfill(3)}.ply"), pc)

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
