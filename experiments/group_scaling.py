#!/usr/bin/env python3
"""How the group entries of kernels 1 and 2 scale with the group's size F,
on one CUDA GPU.

Run from the root of a checkout:  python3 experiments/group_scaling.py

At the demonstrator rig (640x480 camera, 720x1280 projector, capacity
28672, ``chip_smoke.py``'s frames), for F = 1, 2, 4, 8, 12 frames, the
device ms a call (``chip_smoke.device_ms``: profiler, 50 calls) of:

- kernel 1's staged group entry on the group's rows (``full``), and on the
  same rows with every count 0 (``zero_only``: the launch, the zeroing of
  the F maps and the grid barrier, no lane read);
- kernel 1's staged one-frame entry called once a frame (``loop``);
- kernel 2's group entry, display-packed, on kernel 1's F maps, and its
  one-frame entry called once a frame.

Each group result is checked bit-equal to the one-frame entries'. Prints
the card, one line an F and one JSON line; exits 2 without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SIZES = (1, 2, 4, 8, 12)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("group_scaling: needs a CUDA GPU", file=sys.stderr)
        return 2
    from xmaps_tpu_torch.io.prefetch import stage_compact_group
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter_staged,
        event_disparity_scatter_staged_group,
    )
    from xmaps_tpu_torch.ops.cuda_tail import tail_projector, tail_projector_group
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    calib = make_synthetic_calibration(640, 480, 720, 1280)
    eng = XMapsDepthEngine.from_calibration(
        calib, device="cuda", event_capacity=cs.CAPACITY, z_near=cs.Z_NEAR, z_far=cs.Z_FAR,
        xmap_cache_dir=str(ROOT / "build" / "xmaps_tpu_torch" / "cache"))
    frames = cs.make_frames(calib, max(SIZES), 0.031)
    kw = cs.view_kwargs(eng)[0]
    layout, tables, plan = eng.compact_layout, eng.tables, eng.plan
    disp = dict(emit_aux=False, packed_bgr=True)
    rows = []
    for f in SIZES:
        group = stage_compact_group(frames[:f], cs.CAPACITY, layout, device="cuda")
        empty = group._replace(counts=torch.zeros_like(group.counts),
                               host_counts=(0,) * f)
        ones = [group.word[i] for i in range(f)]

        def full():
            return event_disparity_scatter_staged_group(group, layout, tables, **kw)

        def loop():
            return [event_disparity_scatter_staged(w, n, layout, tables, **kw)
                    for w, n in zip(ones, group.host_counts)]

        maps = full().packed_map
        cs.assert_exact(f"F={f}: group vs one-frame entries", [
            (maps[i], r.packed_map) for i, r in enumerate(loop())])
        cs.assert_exact(f"F={f}: tail group vs one-frame", [
            (tail_projector_group(maps, tables, plan, **disp)[0][i],
             tail_projector(maps[i], tables, plan, **disp)[0]) for i in range(f)])
        ms = {
            "k1_full": cs.device_ms(full)[0],
            "k1_zero_only": cs.device_ms(
                lambda: event_disparity_scatter_staged_group(empty, layout, tables, **kw))[0],
            "k1_loop": cs.device_ms(loop)[0],
            "k2_group": cs.device_ms(lambda: tail_projector_group(maps, tables, plan, **disp))[0],
            "k2_loop": cs.device_ms(
                lambda: [tail_projector(maps[i], tables, plan, **disp) for i in range(f)])[0],
        }
        rows.append(dict(frames=f, events=sum(group.host_counts), **ms))
        print(f"F={f}: " + ", ".join(f"{k} {v:.5f} ms" for k, v in ms.items()) + f" [{card}]",
              flush=True)
    print(json.dumps({"card": card, "capacity": cs.CAPACITY, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
