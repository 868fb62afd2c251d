"""Benchmark: event->depth throughput and latency on one GPU.

Port of the repository's ``bench.py``.  Replays synthetic frames at the
reference demonstrator's geometry (640x480 event camera, 720x1280
scanning projector @60 Hz, ~28k events/frame, capacity 28672 -- paper
setup, BASELINE.md) through the engine's display-only packed frame and
prints ONE JSON line:

    {"metric": "Mevents/s/chip", "value": ..., "unit": "Mevents/s",
     "vs_baseline": ..., "extra": {...}}

``value`` is events per frame over the back-to-back frame time of the
group regime, as the JAX bench's ``run_group``: the 12 frames pre-staged
as one group (``XMapsDepthEngine.stage_group``) and dispatched as ONE
program (``ops.frame_pipeline.group_depth_frames``: kernel 1 once, the
tail once), ``ROUNDS`` dispatches between two CUDA events;
``vs_baseline`` is the reference's published 2.67 ms/frame CPU figure
(paper Table 2, BASELINE.md) over that frame time.  ``extra`` holds the
same frames' time dispatched one ``depth_frame`` a frame
(``frame_ms_loop``; the two are timed in turns: group, loop, loop,
group), the synchronous per-frame latency (host clock around one
pre-staged frame + ``torch.cuda.synchronize()``, p50/p95 of 60), the
engine setup (cold, then warm from the disk cache), the warm-up and the
card's name and power limit.  Before anything is timed, the device warm-up launches kernel W
(``warmup_add_one``, the port of the JAX bench's ``_noop``).

    python -m xmaps_tpu_torch.apps.bench              # on the card
    python -m xmaps_tpu_torch.apps.bench --device cpu --camera 64 48 \\
        --projector 90 160                            # plain versions

Any failure raises (non-zero exit).  On ``--device cpu`` the times are the
host's and ``gpu`` is null.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine, resolve_device
from xmaps_tpu_torch.ops.frame_pipeline import depth_frame, group_depth_frames
from xmaps_tpu_torch.ops.warmup import WARMUP_SHAPE, warmup_add_one
from xmaps_tpu_torch.utils.synthetic import (
    make_synthetic_calibration,
    simulate_plane_events,
)

#: reference CPU per-frame latency (paper Table 2, BASELINE.md)
REF_FRAME_MS = 2.67
#: ~28k events/frame at the demonstrator rig (ESL-seq1-like density), and
#: the batch capacity sized to it, as the JAX bench
SUBSAMPLE = 0.031
CAPACITY = 28 * 1024
N_FRAMES = 12
SYNC_FRAMES = 60
ROUNDS = 20


def card_name_and_power_limit() -> tuple[str, float]:
    """(name, power limit in W) of card 0, as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return name, float(limit.split()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--camera", type=int, nargs=2, default=(640, 480), metavar=("W", "H"))
    ap.add_argument("--projector", type=int, nargs=2, default=(720, 1280), metavar=("W", "H"))
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # device warm-up (kernel W) before the setup timer, as the JAX bench
    # runs its _noop Pallas program
    t0 = time.perf_counter()
    one = warmup_add_one(torch.zeros(WARMUP_SHAPE, dtype=torch.int32, device=dev))
    sync()
    if not bool((one == 1).all()):
        raise AssertionError("warm-up kernel: x + 1 != 1")
    warmup_s = time.perf_counter() - t0

    calib = make_synthetic_calibration(*args.camera, *args.projector)
    setups = []
    for _ in range(2):
        t0 = time.perf_counter()
        engine = XMapsDepthEngine.from_calibration(
            calib, device=dev, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
            xmap_cache_dir=os.path.expanduser("~/.cache/xmaps_tpu_torch"),
        )
        sync()
        setups.append(time.perf_counter() - t0)

    rng = np.random.default_rng(7)
    frames = [
        simulate_plane_events(calib, depth_m=0.45 + 0.02 * i,
                              subsample=SUBSAMPLE, jitter_us=2.0, rng=rng)
        for i in range(N_FRAMES)
    ]
    batches = [engine.make_batch(ev) for ev in frames]
    group = engine.stage_group(frames)
    n_events = float(np.mean([min(len(ev), CAPACITY) for ev in frames]))

    def run(batch):
        return depth_frame(batch, engine.tables, engine.cfg, engine.plan,
                           display_only=True, display_packed=True)

    def run_loop():
        for b in batches:
            out = run(b)
        return out.num_inliers

    def run_group():
        return group_depth_frames(group, engine.tables, engine.cfg, engine.plan,
                                  layout=engine.compact_layout, display_only=True,
                                  display_packed=True).num_inliers[-1]

    run_loop()  # warm-up
    run_group()
    sync()

    lat = []
    for i in range(SYNC_FRAMES):
        b = batches[i % N_FRAMES]
        t0 = time.perf_counter()
        run(b)
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)

    def frame_ms_of(fn):
        """ms a frame of ``ROUNDS`` back-to-back calls of ``fn`` (one
        call: the N_FRAMES frames), between two CUDA events."""
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            inliers = fn()
        if cuda:
            end.record()
            end.synchronize()
            total_ms = start.elapsed_time(end)
        else:
            total_ms = (time.perf_counter() - t0) * 1e3
        if int(inliers) <= 0:
            raise AssertionError("pipeline produced no inliers")
        return total_ms / (ROUNDS * N_FRAMES)

    turns = [frame_ms_of(fn) for fn in (run_group, run_loop, run_loop, run_group)]
    frame_ms = (turns[0] + turns[3]) / 2
    loop_ms = (turns[1] + turns[2]) / 2

    gpu, power = card_name_and_power_limit() if cuda else (None, None)
    result = {
        "metric": "Mevents/s/chip",
        "value": n_events / frame_ms / 1e3,
        "unit": "Mevents/s",
        "vs_baseline": REF_FRAME_MS / frame_ms,
        "extra": {
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "events_per_frame": n_events,
            "frame_ms_pipelined": frame_ms,
            "frame_ms_loop": loop_ms,
            "frames_per_group": N_FRAMES,
            "turns_ms_group_loop_loop_group": turns,
            "p50_ms_sync": float(np.percentile(lat, 50)),
            "p95_ms_sync": float(np.percentile(lat, 95)),
            "setup_s": min(setups),
            "setup_first_s": setups[0],
            "warmup_s": warmup_s,
            "ref_frame_ms": REF_FRAME_MS,
            "gpu": gpu,
            "power_limit_w": power,
        },
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
