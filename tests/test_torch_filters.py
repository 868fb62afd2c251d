"""The port's frame dedup filters (``xmaps_tpu_torch.ops.filters``) vs the
JAX package's, on the CPU.

The same padded batches (numpy, from a seed) go through both
``apply_frame_filter``s on a 16x12 camera, so keys collide, with negative
and zero polarities and padding lanes: the validity mask, the rewritten
timestamps and the scatter priority are compared exactly.  Then the whole
frame program with each filter selected, in both views, through
``process_frame`` and the 2-word ``process_staged``, against the JAX
engine bit for bit; and kernel 1's plain version with a priority against
the JAX ``scatter_disp_packed``.  Every comparison is exact.
"""

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xmaps_tpu.io.evt_decoder import EVENT_DTYPE  # noqa: E402
from xmaps_tpu.io.prefetch import HostStagingPool as JPool  # noqa: E402
from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.ops.event_batch import EventBatch as JBatch  # noqa: E402
from xmaps_tpu.ops.filters import FILTER_NAMES as J_NAMES  # noqa: E402
from xmaps_tpu.ops.filters import apply_frame_filter as j_filter  # noqa: E402
from xmaps_tpu.ops.scatter import scatter_disp_packed as j_scatter  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration as j_calib  # noqa: E402
from xmaps_tpu.utils.synthetic import simulate_plane_events  # noqa: E402

from xmaps_tpu_torch.io.prefetch import HostStagingPool  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine  # noqa: E402
from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter_plain  # noqa: E402
from xmaps_tpu_torch.ops.disparity import scale_time  # noqa: E402
from xmaps_tpu_torch.ops.event_batch import EventBatch  # noqa: E402
from xmaps_tpu_torch.ops.filters import FILTER_NAMES, apply_frame_filter  # noqa: E402
from xmaps_tpu_torch.ops.frame_pipeline import filter_events  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration as t_calib  # noqa: E402

torch.set_num_threads(1)

CAM_W, CAM_H, RECT_W = 16, 12, 40
CAPACITY = 1024
VIEWS = {"projector": False, "camera": True}


def _events(rng, n):
    """n events on the 16x12 camera (about 5 a pixel at n=1000), polarity
    in {-1, 0, 1}, times sorted."""
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    ev["x"] = rng.integers(0, CAM_W, n)
    ev["y"] = rng.integers(0, CAM_H, n)
    ev["p"] = rng.choice([-1, 0, 1, 1], n)
    ev["t"] = 1_000 + np.sort(rng.integers(0, 16_000, n))
    return ev


def test_filter_names_match_jax():
    assert FILTER_NAMES == J_NAMES


@pytest.mark.parametrize("n", [600, 1100], ids=["padded", "over_capacity"])
@pytest.mark.parametrize("name", FILTER_NAMES)
def test_apply_frame_filter_matches_jax(name, n):
    rng = np.random.default_rng(len(name) * 7 + n)
    ev = _events(rng, n)
    # rectified x beyond both edges of the rectified width, to clip
    xr = rng.integers(-5, RECT_W + 5, CAPACITY).astype(np.int32)
    kw = dict(name=name, camera_width=CAM_W, camera_height=CAM_H, rect_width=RECT_W)
    got = apply_frame_filter(EventBatch.from_structured(ev, CAPACITY, device="cpu"),
                             torch.from_numpy(xr), **kw)
    want = j_filter(JBatch.from_structured(ev, CAPACITY), jnp.asarray(xr), **kw)
    for field in JBatch._fields:
        a, b = getattr(got.batch, field), np.asarray(getattr(want.batch, field))
        assert a.numpy().dtype == b.dtype, field
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
    assert got.scatter_priority.dtype == torch.int32
    np.testing.assert_array_equal(got.scatter_priority.numpy(),
                                  np.asarray(want.scatter_priority))
    if name != "none":
        # dedup: at most one survivor per key, and only positive events
        valid = got.batch.valid.numpy()
        assert 0 < valid.sum() < (ev["p"][:CAPACITY] == 1).sum()
        assert (got.batch.p.numpy()[valid] == 1).all()


@pytest.mark.parametrize("name", FILTER_NAMES)
def test_rectified_x_read_only_by_first_per_yt(name):
    """Without a rectified x, every filter but first_per_yt gives the same
    batch and priority (exact); first_per_yt refuses."""
    rng = np.random.default_rng(11)
    batch = EventBatch.from_structured(_events(rng, 600), CAPACITY, device="cpu")
    xr = torch.from_numpy(rng.integers(0, RECT_W, CAPACITY).astype(np.int32))
    kw = dict(name=name, camera_width=CAM_W, camera_height=CAM_H, rect_width=RECT_W)
    if name == "first_per_yt":
        with pytest.raises(ValueError, match="rectified x"):
            apply_frame_filter(batch, None, **kw)
        return
    got, want = apply_frame_filter(batch, None, **kw), apply_frame_filter(batch, xr, **kw)
    for a, b in zip((*got.batch, got.scatter_priority), (*want.batch, want.scatter_priority)):
        assert torch.equal(a, b)


def test_unknown_filter_refused():
    batch = EventBatch.from_structured(_events(np.random.default_rng(0), 10), 16,
                                       device="cpu")
    with pytest.raises(ValueError, match="unknown frame filter"):
        apply_frame_filter(batch, batch.x, name="dedup_xy", camera_width=CAM_W,
                           camera_height=CAM_H, rect_width=RECT_W)


# -- the frame program with a filter, against the JAX engine ----------------


@functools.lru_cache(maxsize=None)
def _engines(camera_perspective):
    """This module's own engine pair: the tests switch their filter."""
    kw = dict(event_capacity=2048, z_near=0.2, z_far=1.2,
              camera_perspective=camera_perspective)
    return (JEngine.from_calibration(j_calib(), **kw),
            XMapsDepthEngine.from_calibration(t_calib(), device="cpu", **kw))


@functools.lru_cache(maxsize=None)
def _frames():
    """Two plane frames with repeated pixels (a third of the events fire
    again 1-40 us later) and a fifth of them negative; a frame of events
    at random pixels and times, whose dedup survivors collide in the
    projector view with different disparities (so the scatter priority
    decides the frame); and an empty frame."""
    calib = j_calib()
    rng = np.random.default_rng(11)
    frames = []
    for depth, sub in ((0.5, 0.15), (0.7, 0.3)):
        ev = simulate_plane_events(calib, depth_m=depth, subsample=sub, jitter_us=2.0, rng=rng)
        again = ev[rng.random(len(ev)) < 0.33].copy()
        again["t"] += rng.integers(1, 40, len(again))
        ev = np.concatenate([ev, again])
        ev = ev[np.argsort(ev["t"], kind="stable")]
        ev["p"][rng.random(len(ev)) < 0.2] = 0
        frames.append(ev)
    n = 1500
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    ev["x"] = rng.integers(0, calib.camera_width, n)
    ev["y"] = rng.integers(0, calib.camera_height, n)
    ev["p"] = rng.choice([0, 1, 1, 1], n)
    ev["t"] = np.sort(rng.integers(0, 16_667, n))
    return frames + [ev, frames[0][:0]]


@contextlib.contextmanager
def _filtered(name, camera_perspective):
    """The engine pair with ``name`` selected; back to "none" after."""
    jeng, teng = _engines(camera_perspective)
    jeng.set_frame_filter(name)
    teng.set_frame_filter(name)
    try:
        yield jeng, teng
    finally:
        jeng.set_frame_filter("none")
        teng.set_frame_filter("none")


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.frame_bgr.numpy(), np.asarray(ref.frame_bgr))
    for field in ("depth", "disp_map"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    assert int(got.num_inliers) == int(ref.num_inliers)


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("name", FILTER_NAMES)
def test_process_frame_with_filter_matches_jax(name, view):
    with _filtered(name, VIEWS[view]) as (jeng, teng):
        assert teng.cfg.frame_filter == name
        inliers = []
        for ev in _frames():
            got = teng.process_frame(ev)
            _assert_same(got, jeng.process_frame(ev))
            inliers.append(int(got.num_inliers))
    assert inliers[1] > 300 and inliers[-1] == 0


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("name", FILTER_NAMES[1:])
def test_process_staged_with_filter_matches_jax(name, view):
    """The streaming program with a filter: 2-word staging (raw timestamps
    and polarity); the 1-word form is refused, as in the JAX engine."""
    with _filtered(name, VIEWS[view]) as (jeng, teng):
        pool = HostStagingPool(2048, device="cpu", layout=teng.compact_layout)
        jpool = JPool(2048, layout=jeng.compact_layout)
        for ev in _frames():
            got = teng.process_staged(pool.stage(ev))
            want = jeng.process_staged(jpool.stage(ev))
            np.testing.assert_array_equal(got.frame_bgr.numpy().view(np.uint32),
                                          np.asarray(want.frame_bgr))
            assert int(got.num_inliers) == int(want.num_inliers)
        with pytest.raises(ValueError, match="compact staging"):
            teng.process_staged(pool.stage_compact(_frames()[0]))


def test_set_frame_filter_refuses_unknown_and_keeps_filter():
    _, teng = _engines(False)
    teng.set_frame_filter("last_per_xy")
    try:
        with pytest.raises(ValueError, match="unknown frame filter 'dedup_xy'"):
            teng.set_frame_filter("dedup_xy")
        assert teng.cfg.frame_filter == "last_per_xy"
    finally:
        teng.set_frame_filter("none")


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_kernel1_plain_priority_matches_jax_scatter(view):
    """Kernel 1's plain version with a filter's priority (and with a
    reversed-lane one) against the JAX ``scatter_disp_packed``."""
    _, teng = _engines(VIEWS[view])
    cfg, plan, tables = teng.cfg, teng.plan, teng.tables
    ev = _frames()[1]
    batch = teng.make_batch(ev)
    fb = filter_events(batch, tables, cfg.replace(frame_filter="last_per_xy"))
    n = batch.capacity
    reversed_lanes = torch.arange(n - 1, -1, -1, dtype=torch.int32)
    if cfg.camera_perspective:
        kw = dict(camera_view=True, window=(0, 0), out_shape=(cfg.camera_height, cfg.camera_width))
        height, width, window = cfg.camera_height, cfg.camera_width, None
    else:
        kw = dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
                  out_shape=(plan.H, plan.W))
        height, width = cfg.rect_height, cfg.rect_width
        window = (plan.crop_row0, plan.crop_col0, plan.H, plan.W)
    for fbatch, prio in ((fb.batch, fb.scatter_priority), (batch, reversed_lanes)):
        t_bin = scale_time(fbatch.t, fbatch.valid, cfg.t_px_scale)
        got = event_disparity_scatter_plain(fbatch, t_bin, tables, want_lanes=True,
                                            priority=prio, **kw)
        xr, yr, _ = got.lanes
        inlier = fbatch.valid & (yr >= 0) & (yr < tables.x_map.shape[0] - 1)
        disp = (got.lanes[2] - xr - 4242)
        inlier &= (disp >= 0) & (t_bin >= 0) & (t_bin < tables.x_map.shape[1])
        ys, xs = (fbatch.y, fbatch.x) if cfg.camera_perspective else (yr, xr + disp)
        want = j_scatter(
            jnp.asarray(ys.numpy()), jnp.asarray(xs.numpy()),
            jnp.asarray(torch.where(inlier, disp, 0).float().numpy()),
            jnp.asarray(inlier.numpy()), height=height, width=width,
            priority=jnp.asarray(prio.numpy()), window=window,
        )
        np.testing.assert_array_equal(got.packed_map.numpy().view(np.uint32), np.asarray(want))
        assert int(got.num_inliers) == int(inlier.sum()) > 300
