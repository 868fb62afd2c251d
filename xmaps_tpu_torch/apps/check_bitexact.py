"""Bit-exactness sweep: every frame entry on the card against the CPU port.

Port of the repository's ``eval/check_bitexact.py``.  For each geometry
(``demo``, the demonstrator; ``esl``, the synthetic ESL rig, rectified at
3x the projector) x render view x plane depth, the events of
``simulate_plane_events`` (one generator of seed 11 a view, as the JAX
script's), with ``ev[::7]`` appended (many lanes share a target, and the
later arrival must win) and cut to ``--events`` - 512, run through four
entries of the engine on ``--device``:

- ``process_frame`` (the whole ``FrameResult``);
- the display-packed frame (``display_only``, ``display_packed``; the
  packed plane unpacked to BGR);
- ``process_staged`` of the 1-word staged batch
  (``HostStagingPool.stage_compact``; 2-word where the rig has no 1-word
  layout);
- ``process_frames`` over the geometry's depths as one group;

and each is held field by field, bit for bit, against the CPU port's
``process_frame`` of the same events (the same tables, ``engine.to("cpu")``).
This is the gate a kernel change must pass on the card.  It prints one line
a case, then ONE JSON line ``{"metric": "bitexact_failures", "value": N,
"cases": ...}``, and exits 1 if N > 0.

    python -m xmaps_tpu_torch.apps.check_bitexact                   # on the card
    python -m xmaps_tpu_torch.apps.check_bitexact --geometry esl
    python -m xmaps_tpu_torch.apps.check_bitexact --device cpu --geometry demo \\
        --camera 96 72 --projector 64 96 --events 2048             # plain versions

The JAX script's presort and winner batches (``make_sorted_batch``,
``make_winner_batch``) are TPU-only and have no counterpart.  On ``--device
cpu`` the entries run the kernels' plain versions, so the sweep holds the
staged, packed and group paths against ``process_frame`` on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from xmaps_tpu_torch.apps.measure import add_rig_args, card, tool_rig
from xmaps_tpu_torch.io.prefetch import HostStagingPool
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine, resolve_device
from xmaps_tpu_torch.utils.synthetic import simulate_plane_events

#: the four entries each case runs, in order
ENTRIES = ("process_frame", "display_packed", "process_staged", "process_frames")
FIELDS = ("frame_bgr", "depth", "disp_map", "num_inliers")
#: lanes left free below ``--events``, and the stride of the duplicated
#: events (the JAX script's)
HEADROOM = 512
DUP_STRIDE = 7
SEED = 11


def case_events(calib, depths, events: int, seed: int = SEED) -> list:
    """One frame a depth from one generator of ``seed``: the plane's events,
    ``ev[::7]`` appended, cut to ``events`` - 512 (the JAX script's)."""
    rng = np.random.default_rng(seed)
    frames = []
    for depth_m in depths:
        ev = simulate_plane_events(calib, depth_m=depth_m, subsample=0.031, jitter_us=2.0,
                                   rng=rng)
        frames.append(np.concatenate([ev, ev[::DUP_STRIDE]])[: events - HEADROOM])
    return frames


def as_arrays(res, packed: bool = False) -> dict:
    """A ``FrameResult`` as NumPy arrays by field (None where the entry does
    not emit it); a packed plane unpacked to (H, W, 3) BGR."""
    out = {f: None if getattr(res, f) is None else getattr(res, f).cpu().numpy()
           for f in FIELDS}
    if packed:
        h, w = out["frame_bgr"].shape
        out["frame_bgr"] = np.ascontiguousarray(out["frame_bgr"]).view(np.uint8).reshape(
            h, w, 4)[..., :3]
    return out


def run_entries(eng: XMapsDepthEngine, frames: list) -> list:
    """The four entries of ``eng`` on each frame: one dict a frame, entry ->
    ``as_arrays`` of its result."""
    layout = eng.compact_layout
    pool = HostStagingPool(eng.cfg.event_capacity, device=eng.device, layout=layout)
    group = eng.process_frames(frames)
    out = []
    for ev, g in zip(frames, group, strict=True):
        staged = pool.stage_compact(ev) if layout is not None else pool.stage(ev)
        out.append({
            "process_frame": as_arrays(eng.process_frame(ev)),
            "display_packed": as_arrays(
                eng.process_frame(ev, display_only=True, display_packed=True), packed=True),
            "process_staged": as_arrays(eng.process_staged(staged), packed=True),
            "process_frames": as_arrays(g),
        })
    return out


def mismatches(entries: dict, ref: dict) -> list:
    """``entry field`` for each field an entry emits that is not bit-equal
    (dtype, shape and every element) to ``ref``'s."""
    bad = []
    for entry, got in entries.items():
        for f in FIELDS:
            a, b = got[f], ref[f]
            if a is None:
                continue
            if a.dtype != b.dtype or not np.array_equal(a, b):
                bad.append(f"{entry} {f}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--geometry", choices=["esl", "demo", "both"], default="both")
    ap.add_argument("--events", type=int, default=28 * 1024)
    ap.add_argument("--depths", type=float, nargs="+", default=[0.35, 0.6, 1.0])
    add_rig_args(ap)
    args = ap.parse_args(argv)
    if args.events <= HEADROOM:
        raise ValueError(f"--events {args.events} leaves no lane below the {HEADROOM} free")

    dev = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)
    geoms = ["demo", "esl"] if args.geometry == "both" else [args.geometry]
    failures = cases = 0
    for geom in geoms:
        calib = tool_rig(geom, args.camera, args.projector)
        for view in (False, True):
            eng = XMapsDepthEngine.from_calibration(
                calib, device=dev, event_capacity=args.events, z_near=0.2, z_far=1.2,
                xmap_cache_dir=os.path.expanduser("~/.cache/xmaps_tpu_torch"),
                camera_perspective=view,
            )
            ref = eng if dev.type == "cpu" else eng.to("cpu")
            frames = case_events(calib, args.depths, args.events)
            entries = run_entries(eng, frames)
            name = "camera" if view else "projector"
            for depth_m, ev, got in zip(args.depths, frames, entries):
                want = as_arrays(ref.process_frame(ev))
                bad = mismatches(got, want)
                cases += 1
                if bad:
                    failures += 1
                    for b in bad:
                        print(f"MISMATCH {geom} view={name} depth={depth_m} {b}", flush=True)
                else:
                    print(f"OK {geom} view={name} depth={depth_m} events={len(ev)} "
                          f"inliers={int(want['num_inliers'])} "
                          f"(+packed +staged +group)", flush=True)
    print(f"{failures} FAILURES" if failures else "ALL BIT-EXACT", flush=True)
    print(json.dumps({
        "metric": "bitexact_failures", "value": failures, "cases": cases,
        "entries": list(ENTRIES), "geometries": geoms, "depths": args.depths,
        "events": args.events, "device": dev.type, **card(dev),
    }), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
