"""Cold-start attribution on one GPU: where does a process's first minute go?

Port of the repository's ``eval/profile_setup.py``.  Fences every step of
the bench's setup with wall clocks and prints ONE JSON line:

- ``import_torch_s``: ``import torch``;
- ``backend_init_s``: ``torch.cuda.init()`` and the first tensor on the card;
- the first transfers: a tiny put (and ``+ 1``), 32 MB host to device, 1 MB
  device to host;
- ``kernel_library_s``: ``ops._build.load()``, fenced alone before the
  engine builds: the nvcc build of the six sources when the build directory
  is cold, the load of the ``.so`` when it is warm;
- ``first_kernel_program_s``: kernel W's first launch (``warmup_add_one``,
  the port of the JAX script's first Mosaic program, its ``_noop``);
- ``engine_build{1,2}_s`` and their steps (``XMapsDepthEngine.setup_timings``)
  at the demonstrator rig (640x480 camera, 720x1280 projector, capacity
  28672), build 2 from the disk cache build 1 filled;
- the first and a second ``process_frame`` (seed 5, a plane at 0.5 m) and
  ``process_frames`` of 12 frames (0.45 + 0.02 i m), each up to its inlier
  count on the host.

``XMAPS_SETUP_COLD=1`` points ``XMAPS_TORCH_BUILD_DIR`` and the X-map /
calibration cache at fresh temporary directories (removed at the end), so
the run sees a cold machine without deleting anything; by default the
run uses the checkout's build directory and ``~/.cache/xmaps_tpu_torch``.
``XMAPS_SETUP_TRACE=1`` prints each engine step as it ends.

    python -m xmaps_tpu_torch.apps.profile_setup                   # on the card, warm
    XMAPS_SETUP_COLD=1 python -m xmaps_tpu_torch.apps.profile_setup
    python -m xmaps_tpu_torch.apps.profile_setup --device cpu \\
        --camera 96 72 --projector 64 96                          # plain versions

On ``--device cpu`` the card's steps (backend, transfers, kernel library,
kernel program) are null and the rest are the host's times.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--camera", type=int, nargs=2, metavar=("W", "H"), default=(640, 480))
    ap.add_argument("--projector", type=int, nargs=2, metavar=("W", "H"), default=(720, 1280))
    args = ap.parse_args(argv)
    cold = os.environ.get("XMAPS_SETUP_COLD") == "1"
    with contextlib.ExitStack() as stack:
        cache_dir = os.path.expanduser("~/.cache/xmaps_tpu_torch")
        if cold:
            tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="xmaps_setup_cold_"))
            stack.enter_context(_environ("XMAPS_TORCH_BUILD_DIR", os.path.join(tmp, "build")))
            cache_dir = os.path.join(tmp, "cache")
        out = run(args, cold, cache_dir)
    print(json.dumps(out), flush=True)
    return 0


@contextlib.contextmanager
def _environ(key: str, value: str):
    """``os.environ[key] = value`` for the block, then as it was."""
    old = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old


def run(args, cold: bool, cache_dir: str) -> dict:
    out = {"metric": "setup_breakdown_s", "cold_caches": cold}
    t0 = time.perf_counter()
    import torch

    out["import_torch_s"] = time.perf_counter() - t0

    from xmaps_tpu_torch.apps.measure import card
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine, resolve_device
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.ops.warmup import WARMUP_SHAPE, warmup_add_one
    from xmaps_tpu_torch.utils.synthetic import (
        make_synthetic_calibration,
        simulate_plane_events,
    )

    cuda = args.device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            resolve_device("cuda")  # raises: no card
        t0 = time.perf_counter()
        torch.cuda.init()
        dev = torch.device("cuda")
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
        out["backend_init_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        torch.from_numpy(np.zeros(8, np.float32)).to(dev).add_(1)
        torch.cuda.synchronize(dev)
        out["first_tiny_put_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.from_numpy(np.zeros(32 << 20, np.uint8)).to(dev)
        torch.cuda.synchronize(dev)
        out["first_32mb_put_s"] = time.perf_counter() - t0
        buf = torch.zeros(1 << 20, dtype=torch.uint8, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        buf.cpu().numpy()
        out["first_1mb_get_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        _build.load()
        out["kernel_library_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        y = warmup_add_one(torch.zeros(WARMUP_SHAPE, dtype=torch.int32, device=dev))
        if int(y.sum()) != y.numel():
            raise AssertionError("kernel W: x + 1 != 1")
        out["first_kernel_program_s"] = time.perf_counter() - t0
    else:
        dev = resolve_device("cpu")
        out.update(backend_init_s=None, first_tiny_put_s=None, first_32mb_put_s=None,
                   first_1mb_get_s=None, kernel_library_s=None, first_kernel_program_s=None)

    calib = make_synthetic_calibration(
        camera_width=args.camera[0], camera_height=args.camera[1],
        projector_width=args.projector[0], projector_height=args.projector[1])
    for build in (1, 2):
        t0 = time.perf_counter()
        eng = XMapsDepthEngine.from_calibration(
            calib, device=dev, event_capacity=28 * 1024, z_near=0.2, z_far=1.2,
            xmap_cache_dir=cache_dir)
        out[f"engine_build{build}_s"] = time.perf_counter() - t0
        out[f"engine_build{build}_steps"] = {label: dt for label, dt in eng.setup_timings}

    rng = np.random.default_rng(5)
    evs = simulate_plane_events(calib, depth_m=0.5, subsample=0.031, jitter_us=2.0, rng=rng)
    for key in ("first_frame_s", "frame_run_s"):
        t0 = time.perf_counter()
        res = eng.process_frame(evs)
        if int(res.num_inliers) <= 0:
            raise AssertionError("no inliers")
        out[key] = time.perf_counter() - t0
    frames = [simulate_plane_events(calib, depth_m=0.45 + 0.02 * i, subsample=0.031,
                                    jitter_us=2.0, rng=rng) for i in range(12)]
    for key in ("first_group12_s", "group12_run_s"):
        t0 = time.perf_counter()
        outs = eng.process_frames(frames)
        if int(outs[-1].num_inliers) <= 0:
            raise AssertionError("no inliers in the group's last frame")
        out[key] = time.perf_counter() - t0
    out["device"] = dev.type
    out.update(card(dev))
    return out


if __name__ == "__main__":
    sys.exit(main())
