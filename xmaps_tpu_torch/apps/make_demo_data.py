"""Generate a self-contained demo dataset: calibration YAML + EVT3 .raw.

Port of the JAX package's ``apps/make_demo_data.py``: NumPy over the
port's copies of the EVT3 encoder and the synthetic rig, same flags and
byte-identical output.  Lets anyone run the full live-replay pipeline (and
the offline eval) with zero hardware and zero downloads:

    python -m xmaps_tpu_torch.apps.make_demo_data --out-dir demo
    python -m xmaps_tpu_torch.apps.depth_reprojection \\
        --calib demo/calibration.yaml --input demo/events.raw \\
        --z-near 0.3 --z-far 1.2 --window files --out-dir demo/frames \\
        --device cpu      # or cuda (the default) on the card

The default scene is a bouncing sphere and a floating box over a tilted
backdrop (--scene shapes; "sweep" and "wave" animate a plane instead),
observed by a simulated 640x480 event camera watching a 720x1280 @60 Hz
scanning laser projector -- the reference demonstrator's geometry
(README.md:30, paper html:260-263).  The recording is written in the
Prophesee EVT3 format our native decoder reads, with the inter-frame
blanking pauses the trigger finder keys on (trigger_finder.py:98).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def write_xmaps_yaml(path: str, calib) -> None:
    """Write the X-maps calibration dialect (cam_proj_calibration.py:77-108)."""

    def mat(name, m):
        m = np.asarray(m, dtype=np.float64)
        rows = m.shape[0]
        cols = m.shape[1] if m.ndim > 1 else 1
        data = ", ".join(repr(float(v)) for v in m.ravel())
        return (
            f"{name}: !!opencv-matrix\n"
            f"  rows: {rows}\n  cols: {cols}\n  dt: d\n"
            f"  data: [ {data} ]\n"
        )

    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write(mat("camera_intrinsic_matrix", calib.camera_K))
        f.write(mat("camera_distortion_coefficients", calib.camera_D.reshape(1, -1)))
        f.write(mat("projector_intrinsic_matrix", calib.projector_K))
        f.write(
            mat("projector_distortion_coefficients", calib.projector_D.reshape(1, -1))
        )
        f.write(mat("relative_rotation", calib.cam2proj_R))
        f.write(mat("relative_translation", calib.cam2proj_T))


def shapes_depth_map(proj_w: int, proj_h: int, phase: float = 0.0) -> np.ndarray:
    """A (H_proj, W_proj) scene: tilted backdrop, a bouncing sphere and a
    floating box (depths in meters, projector view)."""
    ys, xs = np.mgrid[0:proj_h, 0:proj_w].astype(np.float64)
    u = xs / proj_w
    v = ys / proj_h
    depth = 0.85 + 0.15 * u + 0.05 * v  # tilted backdrop

    # sphere bump (orbits slowly with phase)
    cx = 0.5 + 0.18 * np.sin(2 * np.pi * phase)
    cy = 0.45 + 0.1 * np.cos(2 * np.pi * phase)
    r = 0.18
    d2 = ((u - cx) / r) ** 2 + ((v - cy) / (r * proj_w / proj_h)) ** 2
    bump = np.where(d2 < 1.0, np.sqrt(np.clip(1.0 - d2, 0, 1)), 0.0)
    depth = depth - 0.22 * bump

    # floating box
    in_box = (np.abs(u - 0.72) < 0.1) & (np.abs(v - 0.72) < 0.12)
    depth = np.where(in_box, 0.5, depth)
    return depth


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate demo calibration + events")
    parser.add_argument("--out-dir", default="demo_data")
    parser.add_argument("--frames", type=int, default=60, help="Projector frames")
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--camera-width", type=int, default=640)
    parser.add_argument("--camera-height", type=int, default=480)
    parser.add_argument("--projector-width", type=int, default=720)
    parser.add_argument("--projector-height", type=int, default=1280)
    parser.add_argument(
        "--density", type=float, default=0.03,
        help="Fraction of projector pixels firing per frame (~30k events at 0.03)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--scene", choices=["sweep", "wave", "shapes"], default="shapes",
        help="sweep: plane sweeping 0.4->0.9 m; wave: depth ripple; "
        "shapes: a bouncing sphere and box over a tilted backdrop",
    )
    args = parser.parse_args(argv)

    from xmaps_tpu_torch.io.evt_encode import encode_evt3
    from xmaps_tpu_torch.utils.synthetic import (
        make_synthetic_calibration,
        simulate_sequence,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    calib = make_synthetic_calibration(
        camera_width=args.camera_width,
        camera_height=args.camera_height,
        projector_width=args.projector_width,
        projector_height=args.projector_height,
    )
    yaml_path = os.path.join(args.out_dir, "calibration.yaml")
    write_xmaps_yaml(yaml_path, calib)

    rng = np.random.default_rng(args.seed)
    if args.scene == "sweep":
        depths = [
            0.4 + 0.5 * (k / max(args.frames - 1, 1)) for k in range(args.frames)
        ]
    elif args.scene == "wave":
        depths = [
            0.6 + 0.2 * np.sin(2 * np.pi * k / 30) for k in range(args.frames)
        ]
    else:
        depths = [
            shapes_depth_map(
                args.projector_width, args.projector_height, phase=k / 30
            )
            for k in range(args.frames)
        ]
    # simulate_sequence inserts the vertical-blanking pauses the trigger
    # finder keys on (utils/synthetic.py)
    events = simulate_sequence(
        calib,
        depths,
        fps=args.fps,
        subsample=args.density,
        jitter_us=2.0,
        rng=rng,
    )
    raw_path = os.path.join(args.out_dir, "events.raw")
    with open(raw_path, "wb") as f:
        f.write(encode_evt3(events, args.camera_width, args.camera_height))
    print(
        f"Wrote {yaml_path} and {raw_path} "
        f"({len(events)} events, {args.frames} frames @ {args.fps} Hz)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
