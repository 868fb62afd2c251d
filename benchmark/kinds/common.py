"""What the kinds of traffic share: the engine of a configuration, the reference's
tables, the frames a run keeps for the comparison, and the comparison's
numbers."""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

from benchmark.reference import calib as ref_calib

#: a run keeps the device outputs of one frame (or group call) in this many
SAMPLE_EVERY = 16


def kept(index: int, seed: int) -> bool:
    """Whether frame (or call) ``index`` is in the seed's sample, about one
    in SAMPLE_EVERY, spread over the window."""
    return (index * 2654435761 + seed * 40503) % (2**32) % SAMPLE_EVERY == 0


def build_engine(run, capacity: int, camera_view: bool):
    """The program's engine of the run's rig, its maps and X-map cached in
    the checkout; its build steps go to standard error."""
    from xmaps_tpu_torch.calib.maps import CalibrationParams
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine

    rig, cfg = run.cfg["rig"], run.cfg
    calib = CalibrationParams(
        camera_width=rig["camera_width"], camera_height=rig["camera_height"],
        projector_width=rig["projector_width"], projector_height=rig["projector_height"],
        rect_image_width=rig["rect_width"], rect_image_height=rig["rect_height"],
        camera_K=np.array(rig["camera_K"]), camera_D=np.array(rig["camera_D"]),
        projector_K=np.array(rig["projector_K"]), projector_D=np.array(rig["projector_D"]),
        cam2proj_R=np.array(rig["cam2proj_R"]), cam2proj_T=np.array(rig["cam2proj_T"]),
    )
    eng = XMapsDepthEngine.from_calibration(
        calib, device=run.device, event_capacity=capacity, z_near=cfg["z_near"],
        z_far=cfg["z_far"], camera_perspective=camera_view,
        xmap_cache_dir=os.path.join(run.cache_dir, "engine"))
    for label, s in eng.setup_timings:
        print(f"engine set-up {label}: {s:.6f} s", file=sys.stderr)
    return eng


def reference_tables(run, device):
    """The plain reference's tables of the run's rig (the host math cached
    in the checkout, the X-map built on ``device``)."""
    from benchmark.reference.frame import Tables

    rig = run.cfg["rig"]
    key = hashlib.sha256(json.dumps(rig, sort_keys=True).encode()
                         + open(ref_calib.__file__, "rb").read()).hexdigest()[:20]
    path = os.path.join(run.cache_dir, "reference", f"{run.cfg['name']}-{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            tabs = {k: z[k] for k in z.files}
    else:
        tabs = ref_calib.rig_tables(rig)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.npz"
        np.savez(tmp, **tabs)
        os.replace(tmp, path)
    return Tables(tabs, rig, device)


def limits(values: dict) -> dict:
    """The compared numbers beside their limits: every one is an exact
    comparison (limit 0)."""
    return {k: {"value": int(v), "limit": 0} for k, v in values.items()}


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))
