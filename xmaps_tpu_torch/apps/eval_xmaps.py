"""Offline eval: ESL-style time-surface scans -> depth maps + point clouds.

Port of ``xmaps_tpu.apps.eval_xmaps`` (the reference's
eval/compute_depth_x_maps.py): loads per-scan .npy time-surface images,
treats nonzero pixels as events with t = normalized intensity, and runs
the camera-view depth engine with the ESL compatibility modes
(zero_undistort_proj_map=True, scan_upwards=False, BORDER_CONSTANT).  A
scan is one batch of up to cam_w * cam_h events (307200 at 640 x 480):
kernel 1 (rectify, X-map gather, packed scatter) then kernel 3 (camera
view colorize) on the card.

``-devices N`` with N > 1 shards groups of N scans over a data-only mesh
(``run_sharded``: ``parallel.make_sharded_pipeline``, one scan a device),
as the JAX app does: ``cuda:0`` .. ``cuda:N-1`` with ``-device cuda`` (it
raises where fewer cards are visible; 0 means every visible card), N
virtual CPU devices with ``-device cpu``.  Each scan's depth ``.npy`` is
byte-equal to ``-devices 1``'s; point clouds are computed single-device.
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


def run_sharded(engine, scans, mesh, depth_dir: str) -> int:
    """The depth maps of ``scans`` (an iterable of (scan id, events of
    ``scan_image_to_events``)) over the ``data`` axis of ``mesh``: groups
    of ``data`` scans through one ``make_sharded_pipeline`` call each, the
    trailing group padded with its first scan (as the JAX app pads it;
    the padding's outputs are dropped), each depth map saved as
    ``scans{id:03d}.npy`` in ``depth_dir``.  Returns the scans saved."""
    from xmaps_tpu_torch.ops.event_batch import EventBatch
    from xmaps_tpu_torch.parallel import make_sharded_pipeline, shard_batches

    n_dev = mesh.shape["data"]
    pipeline = make_sharded_pipeline(engine.cfg, engine.tables, mesh, engine.plan)
    group, group_ids = [], []
    saved = 0

    def flush_group():
        nonlocal saved
        if not group:
            return
        while len(group) < n_dev:  # pad the trailing group
            group.append(group[0])
        t0 = time.time()
        out = pipeline(shard_batches(group, mesh, engine.cfg))
        depths = out.depth.cpu().numpy()
        print(f"Completed {len(group_ids)} scans on {n_dev} devices in {time.time() - t0:.3f}s")
        for k, i in enumerate(group_ids):
            np.save(os.path.join(depth_dir, f"scans{str(i).zfill(3)}.npy"), depths[k])
        saved += len(group_ids)
        group.clear()
        group_ids.clear()

    for i, events in scans:
        group.append(EventBatch.from_arrays(
            events["x"], events["y"], events["t"], events["p"],
            engine.cfg.event_capacity, device="cpu",
        ))
        group_ids.append(i)
        if len(group) == n_dev:
            flush_group()
    flush_group()
    return saved


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
        help="Number of devices (0 = all visible cards): groups of N scans, one a "
        "device (with -device cpu, N virtual CPU devices)",
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

    from xmaps_tpu_torch.parallel import make_mesh

    n_dev = args.devices
    if n_dev == 0:
        n_dev = torch.cuda.device_count() if args.device == "cuda" else 1
    mesh = None
    if n_dev > 1:
        # make_mesh raises for a cuda:i that is not there
        names = [f"cuda:{i}" for i in range(n_dev)] if args.device == "cuda" else ["cpu"] * n_dev
        mesh = make_mesh(names, data=n_dev, event=1)

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

    scan_ids = range(args.start_scan, min(args.start_scan + args.num_scans, len(scan_files)))

    def scans(say_skips=True):
        for i in scan_ids:
            events = scan_image_to_events(np.load(scan_files[i]))
            if events is None:
                if say_skips:
                    print(f"Skip camera npy file {scan_files[i]} since it is empty")
                continue
            yield i, events

    if mesh is not None:
        run_sharded(engine, scans(), mesh, depth_dir)
        if args.no_pointcloud:
            return 0
        print("Note: point clouds are computed single-device; rerun with "
              "-devices 1 (or accept the serial pass below).")

    for i, events in scans(say_skips=mesh is None):
        batch = EventBatch.from_arrays(
            events["x"], events["y"], events["t"], events["p"],
            engine.cfg.event_capacity, device=engine.device,
        )
        if mesh is None:
            print(f"Processing frame: {i}, camera npy file {scan_files[i]}")
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
