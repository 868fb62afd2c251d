"""ESL baseline (init + refined) for the offline evaluation, in PyTorch:
the CLI.

Port of ``xmaps_tpu.apps.eval_esl``'s ``main``: the reference's
eval/compute_depth_esl.py run over a sequence's scans, writing the planes
the evaluation table reads (esl/depth_init and the refined
esl/depth_optim_filtered pseudo-ground-truth).  The pipeline itself (the
disparity init, the refinement, the bilateral + split-Bregman TV denoise)
is ``models.esl_pipeline``; ``main`` runs the scans through its
``ESLDepthEngine.process_scans``, ``GROUP_SCANS`` (12) at a time.  Every
entry point runs on an explicit device: ``-device cuda`` (the default)
needs a card, ``-device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from xmaps_tpu_torch.calib.maps import CalibrationParams
from xmaps_tpu_torch.models import esl_pipeline
from xmaps_tpu_torch.models.depth_pipeline import resolve_device


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
