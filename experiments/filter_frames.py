#!/usr/bin/env python3
"""Filtered and unfiltered frames, wall and device ms a frame, for the
package of the checkout at ``--root`` (default: this one), on one CUDA GPU.

Run from the root of a checkout:  python3 experiments/filter_frames.py [--root DIR]

To compare two trees on one card, run it for each tree in turns (A, B, B,
A) on one machine, ``DIR`` the root of the other tree (an unpacked ``git
archive``: its package builds its kernels under its own ``build/``).  The
frames and the timing are this checkout's ``chip_smoke.py`` helpers; the
engine, the filters and the kernels are ``DIR``'s.

At the demonstrator rig (640x480 camera, 720x1280 projector, capacity
28672), on ``chip_smoke``'s 12 frames, in both views: for each name of
``FILTER_NAMES`` (``none`` too) the display-packed ``process_frame``'s
wall ms a frame (median and p90 of 60, host clock + synchronize) and
device ms a frame (profiler, 48 frames), ``chip_smoke.time_frames``; then
``process_frames`` of the 12 frames with ``first_per_xy`` (chip_smoke's
filtered group), wall ms a group (median of 20) and device ms a group
(profiler, 10 groups).  Prints the card and one JSON line; exits 2
without CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="root of the checkout whose xmaps_tpu_torch is timed")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("filter_frames: needs a CUDA GPU", file=sys.stderr)
        return 2
    import xmaps_tpu_torch
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration

    if Path(xmaps_tpu_torch.__file__).resolve().parent.parent != root:
        raise AssertionError(f"imported {xmaps_tpu_torch.__file__}, not the package of {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    calib = make_synthetic_calibration(640, 480, 720, 1280)
    frames = cs.make_frames(calib, cs.N_FRAMES, 0.031)
    out = {"root": str(root), "gpu": card, "frames": {}, "group": {}}
    for view, camera in (("projector", False), ("camera", True)):
        eng = XMapsDepthEngine.from_calibration(
            calib, device="cuda", event_capacity=cs.CAPACITY, z_near=cs.Z_NEAR,
            z_far=cs.Z_FAR, camera_perspective=camera,
            xmap_cache_dir=str(HERE / "build" / "xmaps_tpu_torch" / "cache"))
        for name in FILTER_NAMES:
            eng.set_frame_filter(name)
            wall, p90, dev, _ = cs.time_frames(eng, frames)
            out["frames"][f"{view} {name}"] = dict(wall_ms=wall, wall_p90_ms=p90, device_ms=dev)
        eng.set_frame_filter("first_per_xy")
        eng.process_frames(frames)
        torch.cuda.synchronize()
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            eng.process_frames(frames)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        dev, _ = cs.profile_calls(lambda: eng.process_frames(frames), 10)
        out["group"][f"{view} first_per_xy"] = dict(wall_ms=statistics.median(walls),
                                                   device_ms=dev)
        eng.set_frame_filter("none")
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
