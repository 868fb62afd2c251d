"""Per-frame device stage budget of the pre-staged group program.

Port of the repository's ``eval/profile_trace.py``.  The frames of
``apps.bench_geometry.make_frames`` (seed 7; 24 at the demonstrator, 12 at
the ESL rig, or ``--frames``) are staged once (``XMapsDepthEngine.stage_group``)
and three group calls (``ops.frame_pipeline.group_depth_frames``: kernel
1's group entry once, the view's tail group entry once) run under
torch.profiler (``utils.profiling.device_events``: between two marker
kernels, with untimed calls on each side).  The device events are bucketed
by name:

- ``event_kernel``: ``event_disparity_scatter*`` (kernel 1);
- ``tail_kernel``: ``tail_dilate*``, ``tail_remap_colorize*`` (kernel 2, two
  launches) and ``colorize_camera*`` (kernel 3);
- ``scatter``: 0.0 always: kernel 1 scatters its lanes itself (one packed
  ``atomicMax``), so no device event of its own is a scatter;
- ``other``: memsets, copies and torch's elementwise kernels.

``module_total_us`` is the span of a call from its first device event to
its last, a frame; ``busy_share`` is ``device_ops_total_us`` over it.
``classification_ok`` is true only where the bucketed kernels equal the
launches ``ops._build.LAUNCHES`` counted for the same calls (kernel 2 is two
device kernels a launch); on the CPU there are no CUDA events, so it is
false and the times are null.  On ``cuda`` a window without kernel events
raises: there is no budget of zeros.

    python -m xmaps_tpu_torch.apps.profile_trace                      # on the card
    python -m xmaps_tpu_torch.apps.profile_trace --geometry esl --camera-perspective
    python -m xmaps_tpu_torch.apps.profile_trace --device cpu --frames 2 \\
        --camera 96 72 --projector 64 96                              # plain versions

Surfaces: the streaming display surface by default (display-only, the
packed-BGR plane), ``--display-only`` the unpacked BGR, ``--full`` the whole
``FrameResult``.  Prints the top events, then ONE JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

from xmaps_tpu_torch.apps.bench_geometry import make_frames
from xmaps_tpu_torch.apps.measure import add_rig_args, call_spans, card, sync, tool_rig
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine, resolve_device
from xmaps_tpu_torch.ops import _build
from xmaps_tpu_torch.ops.frame_pipeline import group_depth_frames

BUCKETS = ("event_kernel", "scatter", "tail_kernel", "other")
#: bucket -> its key in the JSON line (the JAX script's)
US_KEY = {"event_kernel": "event_kernel_us", "scatter": "scatter_us",
          "tail_kernel": "tail_kernel_us", "other": "outside_kernels_us"}
#: device event name -> bucket, by substring
KERNEL_NAMES = {
    "event_disparity_scatter": "event_kernel",
    "tail_dilate": "tail_kernel",
    "tail_remap_colorize": "tail_kernel",
    "colorize_camera": "tail_kernel",
}
#: ``_build.LAUNCHES`` key prefix -> (bucket, device kernels a launch)
LAUNCH_KERNELS = {
    "event_disparity_scatter": ("event_kernel", 1),
    "tail_projector": ("tail_kernel", 2),
    "colorize_camera": ("tail_kernel", 1),
}
#: the events a frame can hold (the JAX script's)
CAPACITY = 28 * 1024
#: profiled group calls, and the duration from which an event is significant
RUNS = 3
SIG_US = 2.0


def classify(name: str) -> str:
    """The bucket of a device event's name."""
    for key, bucket in KERNEL_NAMES.items():
        if key in name:
            return bucket
    return "other"


def expected_kernels(launches: dict) -> dict:
    """Device kernels a bucket should hold for ``launches`` (by
    ``_build.LAUNCHES`` key): kernel 2's launch is two device kernels."""
    want = collections.Counter()
    for key, n in launches.items():
        for prefix, (bucket, per) in LAUNCH_KERNELS.items():
            if key.startswith(prefix):
                want[bucket] += n * per
    return dict(want)


def budget(events: list, frames: int, launches: dict) -> dict:
    """The stage budget of ``events`` (``device_events`` of ``RUNS`` calls
    over ``frames`` frames in all) whose calls counted ``launches``."""
    us = collections.defaultdict(float)
    count = collections.Counter()
    sig = collections.Counter()
    for name, _, dur in events:
        b = classify(name)
        us[b] += dur
        count[b] += 1
        sig[b] += dur >= SIG_US
    want = expected_kernels(launches)
    ok = bool(events) and all(count[b] == want.get(b, 0) for b in ("event_kernel", "tail_kernel"))
    ops_total = sum(us.values())
    module = sum(call_spans(events, RUNS)) if events else 0.0
    return {
        "event_kernel_us": us["event_kernel"] / frames,
        "scatter_us": 0.0,
        "tail_kernel_us": us["tail_kernel"] / frames,
        "outside_kernels_us": us["other"] / frames,
        "device_ops_total_us": ops_total / frames,
        "module_total_us": module / frames,
        "busy_share": ops_total / module if module else None,
        "classification_ok": ok,
        "ops_per_frame": {b: count[b] / frames for b in BUCKETS},
        "significant_ops_per_frame": {b: sig[b] / frames for b in BUCKETS},
        "expected_kernels": want,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--geometry", choices=["demo", "esl"], default="demo")
    ap.add_argument("--display-only", action="store_true",
                    help="display surface but unpacked BGR")
    ap.add_argument("--full", action="store_true",
                    help="the whole FrameResult (depth, disparity, BGR)")
    ap.add_argument("--frames", type=int, default=0,
                    help="group size (default: 24 demo / 12 esl)")
    ap.add_argument("--camera-perspective", action="store_true")
    add_rig_args(ap)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    calib = tool_rig(args.geometry, args.camera, args.projector)
    eng = XMapsDepthEngine.from_calibration(
        calib, device=dev, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
        xmap_cache_dir=os.path.expanduser("~/.cache/xmaps_tpu_torch"),
        camera_perspective=args.camera_perspective,
    )
    n_group = args.frames or (12 if args.geometry == "esl" else 24)
    frames = make_frames(calib, n_group, CAPACITY)
    staged = eng.stage_group(frames)
    disp_only = not args.full
    packed = not args.full and not args.display_only
    calls = [0]

    def run_group():
        calls[0] += 1
        return group_depth_frames(staged, eng.tables, eng.cfg, eng.plan,
                                  layout=eng.compact_layout, display_only=disp_only,
                                  display_packed=packed)

    out = run_group()
    if int(out.num_inliers[-1]) <= 0:
        raise AssertionError("no inliers in the group's last frame")
    sync(dev)
    n = RUNS * n_group
    surface = "full" if args.full else "stream"
    if dev.type == "cuda":
        from xmaps_tpu_torch.utils.profiling import device_events

        before = dict(_build.LAUNCHES)
        calls[0] = 0
        events = device_events(run_group, RUNS)
        sync(dev)
        per_call = {}
        for k in before:
            v = _build.LAUNCHES[k] - before[k]
            if v % calls[0]:
                raise AssertionError(f"{k}: {v} launches over {calls[0]} calls")
            if v:
                per_call[k] = v // calls[0]
        if not any(classify(name) != "other" for name, _, _ in events):
            raise RuntimeError("torch.profiler recorded no kernel event of the group: "
                               "no stage budget")
        result = budget(events, n, {k: v * RUNS for k, v in per_call.items()})
        result["launches_per_call"] = per_call
        by_name = collections.defaultdict(float)
        cnt = collections.Counter()
        for name, _, dur in events:
            by_name[name] += dur
            cnt[name] += 1
    else:
        for _ in range(RUNS):
            run_group()
        # no CUDA events on the host: the times are not measured
        result = budget([], n, {})
        result.update({k: None for k in (*US_KEY.values(), "device_ops_total_us",
                                         "module_total_us")})
        by_name, cnt = {}, {}

    print(f"# surface: {surface}{' (unpacked)' if args.display_only else ''}, "
          f"geometry={args.geometry}, view={'camera' if args.camera_perspective else 'projector'}"
          f", {n_group} frames/group x {RUNS} runs, device {dev.type}")
    if dev.type == "cuda":
        print(f"# module total: {result['module_total_us']:.3f} us/frame; device ops total: "
              f"{result['device_ops_total_us']:.3f} us/frame; busy share "
              f"{result['busy_share']:.3f}")
        for b in BUCKETS:
            print(f"  {b:13s} {result[US_KEY[b]]:9.3f} us/frame")
        print("# top device events:")
        for name, dur in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"{dur / n:9.3f} us/frame  x{cnt[name]:5d}  {name[:90]}")
    print(json.dumps({
        "metric": "device_stage_budget_us_per_frame",
        "geometry": args.geometry,
        "surface": surface,
        "camera_perspective": args.camera_perspective,
        "frames": n_group,
        "runs": RUNS,
        "scatter_note": "kernel 1 scatters its lanes itself: no scatter event of its own",
        **result,
        "device": dev.type,
        **card(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
