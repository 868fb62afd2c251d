"""The port's demo-data generator and per-event debug dump vs the JAX
package's, on the CPU.

``xmaps_tpu_torch.apps.make_demo_data`` must write the same calibration
YAML and EVT3 ``.raw`` as ``xmaps_tpu.apps.make_demo_data``, byte for byte,
for each scene, and ``XMapsDepthEngine.dump_frame_csv`` the same CSV; the
round trip of the JAX package's ``tests/test_demo_data.py`` runs through
the port's decoder, trigger finder and engine.
"""

import csv

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmaps_tpu.apps.make_demo_data import main as j_demo_main  # noqa: E402
from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration as j_calib  # noqa: E402

from xmaps_tpu_torch.apps.make_demo_data import main as demo_main  # noqa: E402
from xmaps_tpu_torch.apps.make_demo_data import shapes_depth_map  # noqa: E402
from xmaps_tpu_torch.calib.maps import CalibrationParams  # noqa: E402
from xmaps_tpu_torch.io.event_iterator import FileEventsIterator  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine  # noqa: E402
from xmaps_tpu_torch.runtime.trigger_finder import RobustTriggerFinder  # noqa: E402
from xmaps_tpu_torch.utils.stats import StatsPrinter  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import (  # noqa: E402
    make_synthetic_calibration,
    simulate_plane_events,
)

torch.set_num_threads(1)

SMALL = ["--frames", "3", "--fps", "60", "--camera-width", "96", "--camera-height", "72",
         "--projector-width", "64", "--projector-height", "96"]


@pytest.mark.parametrize("scene", ["shapes", "sweep", "wave"])
def test_demo_data_matches_jax(tmp_path, scene):
    """The same flags and seed give the same YAML and .raw bytes."""
    args = SMALL + ["--density", "0.5", "--seed", "5", "--scene", scene]
    assert demo_main(["--out-dir", str(tmp_path / "port")] + args) == 0
    assert j_demo_main(["--out-dir", str(tmp_path / "jax")] + args) == 0
    for name in ("calibration.yaml", "events.raw"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
        assert len(got) > 500


def test_demo_data_roundtrip(tmp_path):
    """YAML + EVT3 raw -> the port's decoder and trigger finder -> the
    port's engine recovers the synthesized scene (port of the JAX package's
    quick-start round trip)."""
    out = tmp_path / "demo"
    assert demo_main(["--out-dir", str(out), *SMALL, "--density", "1.0",
                      "--scene", "shapes"]) == 0
    calib = CalibrationParams.from_yaml(str(out / "calibration.yaml"), 96, 72, 64, 96)
    engine = XMapsDepthEngine.from_calibration(calib, device="cpu", event_capacity=8192,
                                               z_near=0.3, z_far=1.2)
    frames = []
    tf = RobustTriggerFinder(projector_fps=60, stats=StatsPrinter(silent=True),
                             frame_callback=lambda e: frames.append(e.copy()))
    for pkt in FileEventsIterator(str(out / "events.raw"), delta_t=1e6 / 240):
        tf.process_events(pkt)
    assert len(frames) >= 1
    depth = engine.process_frame(frames[0]).depth.numpy()
    valid = depth > 0
    assert valid.mean() > 0.2
    # the scene depth range (shapes: ~0.5..1.05 m) must be recovered
    dmap = shapes_depth_map(64, 96, phase=0.0)
    assert abs(np.median(depth[valid]) - np.median(dmap)) < 0.1


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_dump_frame_csv_matches_jax(tmp_path, camera_perspective):
    """The per-frame debug CSV lists every inlier with raw coords,
    rectified coords and disparity, byte for byte as the JAX engine's,
    with the same returned count."""
    kw = dict(event_capacity=8192, z_near=0.2, z_far=1.2,
              camera_perspective=camera_perspective)
    engine = XMapsDepthEngine.from_calibration(make_synthetic_calibration(), device="cpu",
                                               **kw)
    jengine = JEngine.from_calibration(j_calib(), **kw)
    events = simulate_plane_events(make_synthetic_calibration(), depth_m=0.6, subsample=0.3,
                                   rng=np.random.default_rng(2))
    path, jpath = tmp_path / "frame.csv", tmp_path / "jax.csv"
    n = engine.dump_frame_csv(events, str(path))
    assert n == jengine.dump_frame_csv(events, str(jpath)) > 100
    assert path.read_bytes() == jpath.read_bytes()
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == n
    assert (np.array([float(r["disp"]) for r in rows]) >= 0).all()
    yr = np.array([int(r["y_r"]) for r in rows])
    assert (yr >= 0).all() and (yr < engine.cfg.rect_height).all()
