#!/usr/bin/env python3
"""Kernel 1's one-frame entries, device ms a call, for the package of the
checkout at ``--root`` (default: this one), on one CUDA GPU.

Run from the root of a checkout:  python3 experiments/kernel1_one_frame.py [--root DIR]

To compare kernel 1 of two trees on one card, run it for each tree in
turns (A, B, B, A) on one machine, ``DIR`` the root of the other tree (an
unpacked ``git archive``: its package builds its kernels under its own
``build/``).  The frames, the engine's arguments and the profiler timing
are this checkout's ``chip_smoke.py`` helpers; the engine, the kernels and
their wrappers are ``DIR``'s.

At the demonstrator rig (640x480 camera, 720x1280 projector, capacity
28672, projector view), on frame 0 of ``chip_smoke``'s frames: the array
entry on the frame's ``EventBatch`` and the staged entry on its 1-word
staging, each checked bit-equal to its plain version, then the device ms a
call of each (``chip_smoke.device_ms``: profiler, 50 calls) in turns
(array, staged, staged, array).  Prints the card and one JSON line; exits
2 without CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
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
        print("kernel1_one_frame: needs a CUDA GPU", file=sys.stderr)
        return 2
    import xmaps_tpu_torch
    from xmaps_tpu_torch.io.prefetch import HostStagingPool
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter,
        event_disparity_scatter_plain,
        event_disparity_scatter_staged,
        event_disparity_scatter_staged_plain,
    )
    from xmaps_tpu_torch.ops.disparity import scale_time
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration

    if Path(xmaps_tpu_torch.__file__).resolve().parent.parent != root:
        raise AssertionError(f"imported {xmaps_tpu_torch.__file__}, not the package of {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    calib = make_synthetic_calibration(640, 480, 720, 1280)
    eng = XMapsDepthEngine.from_calibration(
        calib, device="cuda", event_capacity=cs.CAPACITY, z_near=cs.Z_NEAR, z_far=cs.Z_FAR,
        xmap_cache_dir=str(HERE / "build" / "xmaps_tpu_torch" / "cache"))
    ev = cs.make_frames(calib, 1, 0.031)[0]
    kw = cs.view_kwargs(eng)[0]
    batch = eng.make_batch(ev)
    t_bin = scale_time(batch.t, batch.valid, eng.cfg.t_px_scale)
    staged = HostStagingPool(eng.cfg.event_capacity, device="cuda",
                             layout=eng.compact_layout).stage_compact(ev)
    staged_args = (staged.word, staged.count, eng.compact_layout, eng.tables)
    calls = {
        "array": lambda: event_disparity_scatter(batch, t_bin, eng.tables, **kw),
        "staged": lambda: event_disparity_scatter_staged(*staged_args, **kw),
    }
    plain = {
        "array": event_disparity_scatter_plain(batch, t_bin, eng.tables, **kw),
        "staged": event_disparity_scatter_staged_plain(*staged_args, **kw),
    }
    for name, fn in calls.items():
        got, ref = fn(), plain[name]
        cs.assert_exact(f"kernel 1's {name} entry vs its plain version", [
            (got.packed_map, ref.packed_map), (got.num_inliers, ref.num_inliers)])
    turns = {k: [] for k in calls}
    for k in ("array", "staged", "staged", "array"):
        turns[k].append(cs.device_ms(calls[k])[0])
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    print(f"{root}: " + ", ".join(f"{k} {ms[k]:.5f} ms (turns {v[0]:.5f}, {v[1]:.5f})"
                                  for k, v in turns.items()) + f" [{card}]", flush=True)
    print(json.dumps({"root": str(root), "card": card, "events": staged.count,
                      "ms": ms, "turns_ms": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
