"""The byte counts of the rooflines against counts made by hand, at both
rigs' sizes and on a tiny rig's frames."""

import os

import numpy as np
import pytest
import torch

from benchmark import harness, roofline
from benchmark.reference import calib, frame as ref_frame
from benchmark.tests.conftest import DATA


def test_esl_group_by_hand():
    # 12 frames of 27648 events, 20000 distinct pixels, 150000 X-map
    # entries, 300 disparities shown; projector 1080 x 1920, crop 1229 x 723
    b = roofline.bytes_of(staged=12 * 27648, lut=20000, xmap=150000, distinct=300, frames=12,
                          out_px=1080 * 1920, proj_px=1080 * 1920, crop_px=1229 * 723)
    words = 4 * 331776                      # 1,327,104
    tables = 4 * 20000 + 2 * 150000         # 380,000
    maps = 2 * 2 * 2073600                  # 8,294,400
    table = 4 * 300                         # 1,200
    out = 12 * (4 * 2073600 + 4)            # 99,532,848
    assert b["group_path"] == words + tables + maps + table + out == 109535552
    crop = 12 * 4 * 888567                  # 42,651,216
    assert b["tail"] == crop + maps + table + 12 * 4 * 2073600 == 150479616


def test_demonstrator_camera_group_by_hand():
    b = roofline.bytes_of(staged=12 * 27648, lut=25000, xmap=200000, distinct=120, frames=12,
                          out_px=640 * 480, proj_px=0, crop_px=0)
    assert b == {"group_path": 1327104 + 100000 + 400000 + 480 + 12 * (1228800 + 4)}
    assert "tail" not in b


@pytest.fixture(scope="module")
def tab():
    rig = harness.load_json(os.path.join(DATA, "configs", "tiny.json"))["rig"]
    return ref_frame.Tables(calib.rig_tables(rig), rig, "cpu")


def _frame(xs, ys, ts):
    ev = np.zeros(len(xs), dtype=[("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<i8")])
    ev["x"], ev["y"], ev["t"], ev["p"] = xs, ys, ts, 1
    return ev


def test_lookups_count_distinct_entries(tab):
    # pixels (10, 20) twice and (11, 20): two LUT entries; the X-map
    # entries are the distinct (rectified row, time bin) pairs
    f = _frame([10, 10, 11], [20, 20, 20], [0, 100, 200])
    n_pix, n_xm, staged = roofline._lookups(tab, [f, f], cap=2)
    assert staged == 4 and n_pix == 1  # capacity 2 keeps (10, 20) twice
    n_pix, n_xm, staged = roofline._lookups(tab, [f], cap=3)
    yr = tab.cam_mapy[20, 10].item(), tab.cam_mapy[20, 11].item()
    bins = ref_frame.time_bins(torch.tensor([0, 100, 200]), tab.x_map.shape[1] - 1).tolist()
    assert n_pix == 2 and staged == 3
    assert n_xm == len({(yr[0], bins[0]), (yr[0], bins[1]), (yr[1], bins[2])})


def test_crop_is_the_sampled_window_with_halo(tab):
    h, w = tab.rect
    px, py = tab.proj_mapx, tab.proj_mapy
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    rows = min(int(py[inb].max()) + 3, h - 1) - max(int(py[inb].min()) - 3, 0) + 1
    cols = min(int(px[inb].max()) + 3, w - 1) - max(int(px[inb].min()) - 3, 0) + 1
    assert roofline.crop_pixels(tab) == rows * cols < h * w


def test_peak_table():
    assert roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_bytes_per_s("another card") is None
