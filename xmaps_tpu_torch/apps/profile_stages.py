"""Stage-by-stage time of the frame program on one GPU.

Port of the repository's ``eval/profile_stages.py``.  The frames of the JAX
script (the demonstrator rig, seed 7, 24 plane frames at 0.45 + 0.02 i m,
subsample 0.031) are staged once as ``EventBatch``es on the device
(``XMapsDepthEngine.make_batch``, capacity 28672) and each stage runs over
all of them a call, one frame after another:

- ``event_scatter_us``: the time binning (``ops.disparity.scale_time``)
  plus kernel 1 (``event_disparity_scatter``: rectify, X-map gather,
  disparity and the scatter into the packed map, one launch);
- ``full_us``: ``ops.frame_pipeline.depth_frame`` (the whole ``FrameResult``);
- ``tail_only_us``: kernel 2 (``tail_projector``) on the frames' packed
  maps, made once, emitting the whole result as ``full_us``;
- ``glue_us`` = full - event_scatter - tail_only.

``event_us`` and ``scatter_us`` are null: kernel 1 gathers and scatters in
one launch and has no entry that stops before the scatter, so the JAX
script's split of the two has no counterpart.  The JAX script's sort stages
(``sort_y5``, ``sort_scatter2``) time TPU presorts the port does not run.

Each stage is timed as the JAX script times it, by group differencing: a
round of k calls keeps at most 3 outputs alive; the fastest of 5 rounds of
each of ``--rounds SMALL LARGE`` calls is taken, and their difference over
the frames between them is the time a frame.  On the card a round is timed
by CUDA events around its calls; on the CPU by the host clock after the
last output.  Prints ONE JSON line (us a frame).

    python -m xmaps_tpu_torch.apps.profile_stages                    # on the card
    python -m xmaps_tpu_torch.apps.profile_stages --device cpu --frames 2 \\
        --camera 96 72 --projector 64 96 --rounds 1 3                # plain versions
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from xmaps_tpu_torch.apps.bench import SUBSAMPLE
from xmaps_tpu_torch.apps.measure import add_rig_args, card, sync, tool_rig
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine, resolve_device
from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter
from xmaps_tpu_torch.ops.cuda_tail import tail_projector
from xmaps_tpu_torch.ops.disparity import scale_time
from xmaps_tpu_torch.ops.frame_pipeline import depth_frame, scatter_view
from xmaps_tpu_torch.utils.synthetic import simulate_plane_events

#: calls in a small and in a large round, the trials of each, and the
#: outputs a round keeps alive (the JAX script's)
ROUNDS = (4, 16)
TRIALS = 5
KEEP = 3


def timed(fn, arg, dev, small: int, large: int) -> float:
    """Seconds a frame of ``fn(arg)`` (``arg`` a list of frames), by group
    differencing (the module docstring)."""
    cuda = dev.type == "cuda"

    def round_(k):
        outs = []
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(k):
            outs.append(fn(arg))
            if len(outs) > KEEP:
                outs.pop(0)
        if cuda:
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    fn(arg)
    sync(dev)
    t_s = min(round_(small) for _ in range(TRIALS))
    t_l = min(round_(large) for _ in range(TRIALS))
    return (t_l - t_s) / (large - small) / len(arg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--rounds", type=int, nargs=2, default=ROUNDS, metavar=("SMALL", "LARGE"))
    add_rig_args(ap)
    args = ap.parse_args(argv)
    small, large = args.rounds
    if not (args.frames >= 1 and 1 <= small < large):
        raise ValueError(f"--frames {args.frames} --rounds {small} {large}")

    dev = resolve_device(args.device)
    calib = tool_rig("demo", args.camera, args.projector)
    eng = XMapsDepthEngine.from_calibration(
        calib, device=dev, event_capacity=28 * 1024, z_near=0.2, z_far=1.2,
        xmap_cache_dir=os.path.expanduser("~/.cache/xmaps_tpu_torch"),
    )
    cfg, tables, plan = eng.cfg, eng.tables, eng.plan
    view = scatter_view(cfg, plan)
    rng = np.random.default_rng(7)
    frames = [eng.make_batch(simulate_plane_events(
        calib, depth_m=0.45 + 0.02 * i, subsample=SUBSAMPLE, jitter_us=2.0, rng=rng))
        for i in range(args.frames)]

    def stage_scatter(bs):
        return [event_disparity_scatter(b, scale_time(b.t, b.valid, cfg.t_px_scale), tables,
                                        **view).packed_map for b in bs]

    def stage_full(bs):
        return [depth_frame(b, tables, cfg, plan) for b in bs]

    def stage_tail(pms):
        return [tail_projector(pm, tables, plan, emit_aux=True, packed_bgr=False) for pm in pms]

    packed = stage_scatter(frames)
    sync(dev)
    out = {}
    for name, fn, arg in (("event_scatter_us", stage_scatter, frames),
                          ("full_us", stage_full, frames),
                          ("tail_only_us", stage_tail, packed)):
        out[name] = timed(fn, arg, dev, small, large) * 1e6
    print(json.dumps({
        "metric": "stage_us_per_frame",
        "event_us": None,
        "scatter_us": None,
        **out,
        "glue_us": out["full_us"] - out["event_scatter_us"] - out["tail_only_us"],
        "frames": args.frames,
        "rounds": [small, large],
        "clock": "cuda events" if dev.type == "cuda" else "host",
        "device": dev.type,
        **card(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
