"""ESL-init time a scan on one GPU: the footprint crop against the full surface.

Port of the repository's ``eval/bench_esl_init.py``.  Times the device path
``models.esl_pipeline`` runs a scan (``build_device_depth_init``): kernel B
remaps the camera image into the static camera footprint's box of the
rectified frame, kernel A searches the box through the prep tables (built
once), kernel B gathers the disparities back to the camera, then depth.
Beside it, the same scan over the full rectified surface (kernel B into
the whole frame, the search with its prep tables built in the call, as the
JAX script's round-4 path, kernel B back); and the ``composed`` remap
variant, which in the port is the same kernel B program as the crop (the
line says so).  All three must give bit-equal disparities and depths.

The calibration is the synthetic ESL rig (``apps.bench_geometry.rig("esl")``:
640x480 camera, 1080x1920 projector, the rectified frame at 3x the
projector), with the eval's maps (``zero_undistort_proj_map``) and its
rectified projector ramp; the JAX script reads the real
``ESL_calib_hhi.yaml``, which this repository does not hold, and the line
names the rig that ran.  The scan is the JAX script's random image (seed
3, 85 % of the pixels lit).

Timing is the JAX script's: groups of 1 and 4 scans (each call's outputs
read once at its end), the fastest of 10 trials of each, their difference
over 3 is the time a scan (host clock; a scan on the card ends in a fetch
of two of its values).  Prints ONE JSON line (``vs_cuda_18_99ms``: the
paper's 18.99 ms a scan over this one).

    python -m xmaps_tpu_torch.apps.bench_esl_init                  # on the card
    python -m xmaps_tpu_torch.apps.bench_esl_init --device cpu \\
        --camera 96 72 --projector 45 80                          # plain versions
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from xmaps_tpu_torch.apps.measure import add_rig_args, card, tool_rig
from xmaps_tpu_torch.calib.maps import CamProjMaps
from xmaps_tpu_torch.models.depth_pipeline import resolve_device
from xmaps_tpu_torch.models.esl_pipeline import build_device_depth_init, depth_from_disparity
from xmaps_tpu_torch.ops.esl_search import esl_disparity_search, rows_monotone
from xmaps_tpu_torch.ops.remap import (
    apply_remap_static,
    build_remap_indices,
    prepare_remap_static,
    upload,
)

#: the paper's CUDA figure a scan (RTX 4090, paper Table 2, BASELINE.md)
REF_SCAN_MS = 18.99
RIG = "synthetic ESL rig"
TRIALS = 10


class EslInit:
    """The synthetic ESL rig's depth-init programs on one device.

    ``crop(cam)`` / ``composed(cam)`` / ``full(cam)`` -> (disparity, depth) in
    the camera view; ``cam`` the scan on the device; ``footprint`` the
    camera footprint's rows and columns of the rectified frame."""

    def __init__(self, dev: torch.device, camera=None, projector=None):
        self.calib = calib = tool_rig("esl", camera, projector)
        maps = CamProjMaps.build_cached(
            calib, zero_undistort_proj_map=True,
            cache_dir=os.path.expanduser("~/.cache/xmaps_tpu_torch"))
        proj_rect = maps.build_rectified_time_map(scan_upwards=False, border_replicate=False)
        if not rows_monotone(proj_rect):
            raise AssertionError("the rectified projector ramp's rows are not monotone")
        p03 = float(maps.P2[0, 3])
        self.crop = build_device_depth_init(maps, calib, proj_rect, p03, dev)
        self.composed = build_device_depth_init(maps, calib, proj_rect, p03, dev)
        H, W = calib.rect_image_height, calib.rect_image_width
        cam_shape = (calib.camera_height, calib.camera_width)
        yi_f, xi_f, inb_f = build_remap_indices(maps.camera_mapx, maps.camera_mapy, cam_shape)
        rows = np.nonzero(inb_f.any(axis=1))[0]
        cols = np.nonzero(inb_f.any(axis=0))[0]
        self.footprint = ((int(rows[0]), int(rows[-1]) + 1), (int(cols[0]), int(cols[-1]) + 1))
        cfg_f, arrs_f = prepare_remap_static(yi_f, xi_f, inb_f, (H, W), cam_shape)
        yi_b, xi_b, inb_b = build_remap_indices(maps.disp_cam_mapx_f32, maps.disp_cam_mapy_f32,
                                                (H, W))
        cfg_b, arrs_b = prepare_remap_static(yi_b, xi_b, inb_b, cam_shape, (H, W))
        arrs_f, arrs_b = upload(arrs_f, dev), upload(arrs_b, dev)
        proj = torch.from_numpy(np.ascontiguousarray(proj_rect, np.float32)).to(dev)

        def full(cam):
            cam_rect = apply_remap_static(cam, arrs_f, cfg_f)
            disp = apply_remap_static(esl_disparity_search(cam_rect, proj), arrs_b, cfg_b)
            return disp, depth_from_disparity(disp, p03)

        self.full = full
        rng = np.random.default_rng(3)
        cam = np.where(rng.random(cam_shape) < 0.85, rng.random(cam_shape), 0).astype(np.float32)
        self.cam = torch.from_numpy(cam).to(dev)


def scan_seconds(fn, cam) -> float:
    """Seconds a scan of ``fn(cam)``: groups of 1 and 4 calls, each ending in
    a fetch of two output values, the fastest of ``TRIALS`` trials of each,
    differenced over 3."""

    def group(reps):
        t0 = time.perf_counter()
        acc = 0.0
        for _ in range(reps):
            disp, depth = fn(cam)
            acc = depth[0, 0] + disp[7, 7] + acc
        float(acc)
        return time.perf_counter() - t0

    group(1)
    group(4)
    t1 = min(group(1) for _ in range(TRIALS))
    t4 = min(group(4) for _ in range(TRIALS))
    best = (t4 - t1) / 3
    if best <= 0:
        raise AssertionError(f"4 scans took no longer than 1: {t4} <= {t1} s")
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    add_rig_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    esl = EslInit(dev, args.camera, args.projector)
    times = {}
    for label, fn in (("crop", esl.crop), ("composed", esl.composed), ("full", esl.full)):
        times[label] = scan_seconds(fn, esl.cam) * 1e3
        print(f"# {label}: {times[label]:.5f} ms/scan", flush=True)
    outs = {label: fn(esl.cam) for label, fn in (("crop", esl.crop), ("composed", esl.composed),
                                                   ("full", esl.full))}
    for label in ("composed", "full"):
        for a, b in zip(outs["crop"], outs[label]):
            if not torch.equal(a, b):
                raise AssertionError(f"the {label} path changed the result")
    c = esl.calib
    H, W = c.rect_image_height, c.rect_image_width
    (r0, r1), (c0, c1) = esl.footprint
    print(json.dumps({
        "metric": "esl_init_ms_per_scan",
        "value": times["crop"],
        "unit": "ms",
        "vs_cuda_18_99ms": REF_SCAN_MS / times["crop"],
        "composed_remap_ms": times["composed"],
        "composed_remap": "kernel B, the same program as the crop",
        "full_surface_ms": times["full"],
        "footprint_rows": [r0, r1],
        "footprint_cols": [c0, c1],
        "footprint_area_frac": (r1 - r0) * (c1 - c0) / (H * W),
        "bit_equal_to_full": True,
        "nonzero_disparities": int((outs["crop"][0] != 0).sum()),
        "geometry": f"{c.camera_width}x{c.camera_height} cam, {c.projector_width}x"
                    f"{c.projector_height} proj, {W}x{H} rect",
        "calib": RIG,
        "device": dev.type,
        **card(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
