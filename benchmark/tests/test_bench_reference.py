"""The plain reference agrees with the port's CPU path on small frames, in
both views, and its stream rules with the port's filters and trigger
finder."""

import os

import numpy as np
import pytest
import torch

from benchmark import generator, harness
from benchmark.reference import calib, frame as ref_frame, stream as ref_stream
from benchmark.tests.conftest import DATA

CFG = harness.load_json(os.path.join(DATA, "configs", "tiny.json"))
RIG = CFG["rig"]


def program_calibration():
    from xmaps_tpu_torch.calib.maps import CalibrationParams

    return CalibrationParams(
        camera_width=RIG["camera_width"], camera_height=RIG["camera_height"],
        projector_width=RIG["projector_width"], projector_height=RIG["projector_height"],
        rect_image_width=RIG["rect_width"], rect_image_height=RIG["rect_height"],
        **{k: np.array(RIG[k]) for k in ("camera_K", "camera_D", "projector_K", "projector_D",
                                         "cam2proj_R", "cam2proj_T")})


@pytest.fixture(scope="module")
def tables():
    return calib.rig_tables(RIG)


def test_calibration_matches_program(tables):
    from xmaps_tpu_torch.calib.maps import CamProjMaps

    maps = CamProjMaps(program_calibration())
    assert np.array_equal(tables["cam_mapx"], maps.disp_cam_mapx_i16)
    assert np.array_equal(tables["cam_mapy"], maps.disp_cam_mapy_i16)
    assert np.array_equal(tables["proj_mapx"], maps.disp_proj_mapx_i16)
    assert np.array_equal(tables["proj_mapy"], maps.disp_proj_mapy_i16)
    assert np.array_equal(tables["time_map"], maps.build_rectified_time_map())
    assert tables["p03"] == maps.P2[0, 3]


@pytest.mark.parametrize("camera_view", [False, True], ids=["projector", "camera"])
@pytest.mark.parametrize("seed", [3, 2**33 + 5])
def test_frame_matches_port_cpu_path(tables, camera_view, seed):
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine

    eng = XMapsDepthEngine.from_calibration(
        program_calibration(), device="cpu", event_capacity=4096, z_near=CFG["z_near"],
        z_far=CFG["z_far"], camera_perspective=camera_view)
    tab = ref_frame.Tables(tables, RIG, "cpu")
    assert torch.equal(tab.x_map, eng.tables.x_map.long())
    traffic = {"frames_per_group": 2, "groups": 1, "events_per_frame": 3000}
    for ev in generator.group_frames(CFG, traffic, seed)[0]:
        res = eng.process_frame(ev, display_only=True, display_packed=True)
        xyz = [torch.from_numpy(ev[k].astype(np.int64)) for k in ("x", "y", "t")]
        img, inl = ref_frame.frame(tab, *xyz, camera_view=camera_view,
                                   z_near=CFG["z_near"], z_far=CFG["z_far"])
        assert inl == int(res.num_inliers) > 100
        assert torch.equal(img, res.frame_bgr)
        low, _ = ref_frame.frame(tab, *xyz, camera_view=camera_view, z_near=CFG["z_near"],
                                 z_far=CFG["z_far"], lower=True)
        assert not torch.equal(low, img)  # the control differs from it


def test_time_bins_exact_half_to_even():
    t = torch.tensor([0, 1, 2, 3, 4], dtype=torch.long)
    # (t - 0) * 3 / 4 = 0, .75, 1.5, 2.25, 3 -> 0, 1, 2 (half to even), 2, 3
    assert ref_frame.time_bins(t, 3).tolist() == [0, 1, 2, 2, 3]


def test_activity_filter_matches_program():
    from xmaps_tpu_torch.io.filters import ActivityNoiseFilter

    traffic = {"loop_frames": 3, "off_share": 0.25}
    loop = generator.loop_frames(CFG, traffic, 11)
    stream = generator.stream_events(loop, 60, 0, 3)
    prog = ActivityNoiseFilter(RIG["camera_width"], RIG["camera_height"], window_us=16666,
                               keep_polarity=1, force_numpy=True)
    # the program filters packet by packet; the reference frame by frame
    got = np.concatenate([prog.process(stream[i:i + 997]) for i in range(0, len(stream), 997)])
    want = [ref_stream.filtered_frame(None, loop[0], RIG["camera_width"], 16666)]
    for k in (1, 2):
        prev, cur = loop[k - 1].copy(), loop[k].copy()
        prev["t"] += generator.frame_start(k - 1, 60)
        cur["t"] += generator.frame_start(k, 60)
        want.append(ref_stream.filtered_frame(prev, cur, RIG["camera_width"], 16666))
    want = np.concatenate(want)
    assert len(want) < int((stream["p"] == 1).sum())  # it drops some
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_segmentation_matches_trigger_finder(seed):
    """At 60 Hz (periods of 16666 and 16667 us) the finder's span test
    drops some frames: the reference drops the same ones."""
    from xmaps_tpu_torch.runtime.trigger_finder import RobustTriggerFinder
    from xmaps_tpu_torch.utils.stats import StatsPrinter

    traffic = {"loop_frames": 12, "off_share": 0.0}
    loop = generator.loop_frames(CFG, traffic, seed)
    ev = generator.stream_events(loop, 60, 0, 12)
    got = []
    finder = RobustTriggerFinder(projector_fps=60, stats=StatsPrinter(silent=True),
                                 frame_callback=got.append)
    for i in range(0, len(ev), 1500):
        finder.process_events(ev[i:i + 1500])
    want = [ev[a:b] for a, b in ref_stream.segment(ev["t"], 1e6 / 60, 40, 1000)]
    # frame 0 has no leading pause, frame 11 no trailing one
    assert 0 < len(want) <= 10
    assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))
