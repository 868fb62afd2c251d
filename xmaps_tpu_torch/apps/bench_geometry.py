"""Per-frame time at a rig geometry on one GPU: the paper's Table-2 rig.

Port of the repository's ``eval/bench_geometry.py``.  ``apps.bench``
measures the demonstrator rig (640x480 camera, 720x1280 projector); the
reference's published 2.67 ms a frame was measured at the ESL eval
geometry: a 640x480 camera, a 1080x1920 projector and the rectified frame
at 3x the projector (5760x3240; paper Table 2).  This script times either
rig (``--geometry esl`` or ``demo``, ``rig``) with the JAX script's
method and prints ONE JSON line.

The frames (``make_frames``: the JAX script's synthetic plane frames from
seed 7, subsampled to ``--events`` - 1024) are staged once
(``XMapsDepthEngine.stage_group``, outside every timer) and each call runs
them as ONE display-packed group (``ops.frame_pipeline.group_depth_frames``:
kernel 1's group entry once and the view's tail group entry once).  The
first call is timed as ``compile_s``.  A round of k calls keeps at most 3
outputs alive and ends with a fetch of a real output pixel and a check
that the last frame has inliers; ``frame_ms`` is the difference of the
fastest of 5 rounds of each of ``--rounds SMALL LARGE`` calls over the
frames between them (the JAX script's way of cancelling a fixed
latency), ``mevents_s`` is in events a frame of the subsampled stream.  On
the card ``device_ms_per_frame`` is the CUDA events' time around the
fastest large round over its frames: where it sits below ``frame_ms`` the
host's issue, not the device, sets the wall.

    python -m xmaps_tpu_torch.apps.bench_geometry --geometry esl     # on the card
    python -m xmaps_tpu_torch.apps.bench_geometry --geometry esl --camera-perspective
    python -m xmaps_tpu_torch.apps.bench_geometry --device cpu --geometry demo \\
        --frames 2 --events 4096 --rounds 1 3                          # plain versions

The JAX script's TPU options (``--no-pallas-events``, ``--no-pallas-tail``,
``--tail-tile``, ``--winners``) have no counterpart and are refused.  Any
failure raises (non-zero exit).  On ``--device cpu`` the times are the
host's, and ``device_ms_per_frame``, ``gpu`` and ``power_limit_w`` are null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from xmaps_tpu_torch.apps.bench import REF_FRAME_MS, SUBSAMPLE, card_name_and_power_limit
from xmaps_tpu_torch.calib.maps import CalibrationParams
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine, resolve_device
from xmaps_tpu_torch.ops.frame_pipeline import group_depth_frames
from xmaps_tpu_torch.ops.staged import CompactStagedGroup
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration, simulate_plane_events

GEOMETRIES = ("esl", "demo")
#: lanes left free below the capacity (the JAX script's headroom)
HEADROOM = 1024
#: calls in a small and in a large round (the JAX script's default), and
#: the trials of each round size, the fastest of which counts
ROUNDS = (6, 30)
TRIALS = 5
#: outputs a round keeps alive
KEEP = 3


def rig(geometry: str) -> CalibrationParams:
    """The rig of ``--geometry``: ``esl``, the paper's Table-2 rig (640x480
    camera, 1080x1920 projector, the rectified frame at 3x the projector:
    5760x3240; a synthetic rig stands in for the ESL calibration, the cost
    is set by the geometry), or ``demo``, the demonstrator (640x480,
    720x1280)."""
    if geometry == "esl":
        calib = make_synthetic_calibration(
            camera_width=640, camera_height=480, projector_width=1080, projector_height=1920)
        return dataclasses.replace(calib, rect_image_width=3 * 1080, rect_image_height=3 * 1920)
    if geometry == "demo":
        return make_synthetic_calibration(
            camera_width=640, camera_height=480, projector_width=720, projector_height=1280)
    raise ValueError(f"unknown geometry {geometry!r} (one of {GEOMETRIES})")


def make_frames(calib: CalibrationParams, n: int, events: int, seed: int = 7) -> list:
    """The JAX script's ``n`` plane frames (depth 0.45 + 0.02 i m, ~28k
    events at the demonstrator), each frame over ``events`` - 1024 events
    cut to that many by a sorted draw without replacement, all from one
    generator of ``seed``."""
    rng = np.random.default_rng(seed)
    target = events - HEADROOM
    frames = []
    for i in range(n):
        ev = simulate_plane_events(calib, depth_m=0.45 + 0.02 * i, subsample=SUBSAMPLE,
                                   jitter_us=2.0, rng=rng)
        if len(ev) > target:
            ev = ev[np.sort(rng.choice(len(ev), size=target, replace=False))]
        frames.append(ev)
    return frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--geometry", choices=GEOMETRIES, default="esl")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--events", type=int, default=28 * 1024)
    ap.add_argument("--camera-perspective", action="store_true")
    ap.add_argument("--rounds", type=int, nargs=2, default=ROUNDS, metavar=("SMALL", "LARGE"))
    args = ap.parse_args(argv)
    small, large = args.rounds
    if not (args.frames >= 1 and args.events > HEADROOM and 1 <= small < large):
        raise ValueError(f"--frames {args.frames} --events {args.events} --rounds {small} {large}")

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # device warm-up before the setup timer: a plain add, as the JAX script's
    if int((torch.zeros(8, device=dev) + 1).sum()) != 8:
        raise AssertionError("warm-up: x + 1 != 1")

    calib = rig(args.geometry)
    t0 = time.perf_counter()
    engine = XMapsDepthEngine.from_calibration(
        calib, device=dev, event_capacity=args.events, z_near=0.2, z_far=1.2,
        xmap_cache_dir=os.path.expanduser("~/.cache/xmaps_tpu_torch"),
        camera_perspective=args.camera_perspective,
    )
    sync()
    setup_s = time.perf_counter() - t0

    frames = make_frames(calib, args.frames, args.events)
    n_events = int(np.mean([len(ev) for ev in frames]))
    n_lanes = int(np.mean([min(len(ev), args.events) for ev in frames]))
    group = engine.stage_group(frames)
    staging = "compact" if isinstance(group, CompactStagedGroup) else "array"

    def run_group():
        return group_depth_frames(group, engine.tables, engine.cfg, engine.plan,
                                  layout=engine.compact_layout, display_only=True,
                                  display_packed=True)

    t0 = time.perf_counter()
    run_group()
    sync()
    compile_s = time.perf_counter() - t0

    def timed_round(k):
        """(wall s, device s or None) of k back-to-back group calls, up to a
        fetch of a real output pixel of the last frame."""
        outs = []
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(k):
            outs.append(run_group())
            if len(outs) > KEEP:
                outs.pop(0)
        if cuda:
            end.record()
        int(outs[-1].frame_bgr[-1, :2, :2].sum())
        wall = time.perf_counter() - t0
        if int(outs[-1].num_inliers[-1]) <= 0:
            raise AssertionError("no inliers")
        return wall, start.elapsed_time(end) / 1e3 if cuda else None

    t_small = min(timed_round(small)[0] for _ in range(TRIALS))
    larges = [timed_round(large) for _ in range(TRIALS)]
    t_large = min(w for w, _ in larges)
    total_s = t_large - t_small
    if total_s <= 0:
        raise AssertionError(f"{large} calls took no longer than {small}: {t_large} <= {t_small} s")
    n_iters = (large - small) * len(frames)
    frame_ms = total_s / n_iters * 1e3
    device_ms = min(d for _, d in larges) / (large * len(frames)) * 1e3 if cuda else None

    if cuda:
        print(f"# peak device memory {torch.cuda.max_memory_allocated(dev)} bytes "
              f"(torch.cuda.max_memory_allocated), staging {staging}", flush=True)
    gpu, power = card_name_and_power_limit() if cuda else (None, None)
    print(json.dumps({
        "geometry": args.geometry,
        "frame_ms": frame_ms,
        "mevents_s": n_events * n_iters / total_s / 1e6,
        "events_per_frame": n_events,
        "device_lanes_per_frame": n_lanes,
        "vs_ref_2p67ms": REF_FRAME_MS / frame_ms,
        "rect": [engine.cfg.rect_height, engine.cfg.rect_width],
        "xmap_shape": list(engine.x_map_np.shape),
        "map_shape": [engine.plan.H, engine.plan.W],
        "setup_s": setup_s,
        "compile_s": compile_s,
        "camera_perspective": args.camera_perspective,
        "staging": staging,
        "device_ms_per_frame": device_ms,
        "frames": len(frames),
        "rounds": [small, large],
        "gpu": gpu,
        "power_limit_w": power,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
