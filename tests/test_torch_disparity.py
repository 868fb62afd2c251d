"""Per-event stage of the port vs the JAX package.

The event batch, rectification, time binning and disparity of
``xmaps_tpu_torch.ops`` against ``xmaps_tpu.ops``, and kernel 1's plain
version (``event_disparity_scatter`` on CPU tensors) against the JAX Pallas
event kernels run in interpret mode.  Every comparison is bit-exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from xmaps_tpu.ops import disparity as jdisp  # noqa: E402
from xmaps_tpu.ops.event_batch import EventBatch as JBatch  # noqa: E402
from xmaps_tpu.ops.pallas_events import (  # noqa: E402
    build_event_gather_hbm_plan,
    build_event_gather_plan,
    rectify_and_lookup,
    rectify_and_lookup_hbm,
)
from xmaps_tpu.ops.scatter import scatter_disp_packed as j_scatter  # noqa: E402
from xmaps_tpu.utils.synthetic import simulate_plane_events  # noqa: E402

from xmaps_tpu_torch.ops import disparity as tdisp  # noqa: E402
from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter  # noqa: E402
from xmaps_tpu_torch.ops.event_batch import EventBatch as TBatch  # noqa: E402
from xmaps_tpu_torch.ops.frame_pipeline import DeviceTables  # noqa: E402

torch.set_num_threads(1)

CAPACITY = 4096


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def rig():
    """``__graft_entry__._make_rig`` sizes: camera 128x96, projector
    180x320, capacity 4096; both packages get the same tables."""
    calib, cfg, jtables, _ = __graft_entry__._make_rig()
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.5, jitter_us=2.0,
        rng=np.random.default_rng(3),
    )
    ttables = DeviceTables.from_numpy(
        *(np.asarray(a) for a in (
            jtables.cam_mapx_i16, jtables.cam_mapy_i16, jtables.x_map,
            jtables.proj_mapx_i16, jtables.proj_mapy_i16, jtables.p03,
        )),
        device="cpu",
    )
    return calib, cfg, jtables, ttables, events


@pytest.mark.parametrize("capacity", [CAPACITY, 1000], ids=["padded", "truncated"])
@pytest.mark.parametrize("float_t", [False, True], ids=["int_t", "float_t"])
def test_event_batch_matches(rig, capacity, float_t):
    events = rig[4]
    assert len(events) > 1000
    if float_t:
        t = (events["t"] - events["t"][0]).astype(np.float32) / 16667.0
        args = (events["x"], events["y"], t, events["p"])
    else:
        # absolute 64-bit timestamps: both rebase to the first event
        args = (events["x"], events["y"], events["t"] + 2**40, events["p"])
    j = JBatch.from_arrays(*args, capacity)
    t = TBatch.from_arrays(*args, capacity, device="cpu")
    for name in JBatch._fields:
        a, b = getattr(t, name), getattr(j, name)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name
        _eq(a, b)
    assert t.capacity == capacity


def test_rectify_events_clips_out_of_range(rig):
    jt, tt = rig[2], rig[3]
    rng = np.random.default_rng(11)
    x = rng.integers(-20, 150, 3000).astype(np.int32)
    y = rng.integers(-20, 120, 3000).astype(np.int32)
    jr = jdisp.rectify_events(jnp.asarray(x), jnp.asarray(y), jt.cam_mapx_i16, jt.cam_mapy_i16)
    tr = tdisp.rectify_events(_t(x), _t(y), tt.cam_mapx_i16, tt.cam_mapy_i16)
    for a, b in zip(tr, jr):
        assert a.dtype == torch.int32
        _eq(a, b)


@pytest.mark.parametrize("floating", [False, True])
def test_time_bounds(floating):
    rng = np.random.default_rng(5)
    t = rng.integers(-1000, 100000, 512)
    t = t.astype(np.float32) / 1e5 if floating else t.astype(np.int32)
    valid = rng.random(512) < 0.7
    for v in (valid, np.zeros_like(valid)):  # an empty mask gives identities
        jb = jdisp.time_bounds(jnp.asarray(t), jnp.asarray(v))
        tb = tdisp.time_bounds(_t(t), _t(v))
        for a, b in zip(tb, jb):
            _eq(a, b)


@pytest.mark.parametrize(
    "scale,span",
    [(179, 2), (179, 16667), (1279, 16667), (89, 6), (719, 1), (319, 97)],
)
def test_scale_time_int_ties_and_padding(scale, span):
    """Exact .5 ties (odd scale over an even span), and padding lanes at
    t = 0 below t_min, whose negative numerators need floor division."""
    rng = np.random.default_rng(scale * 7 + span)
    t0 = 50
    t = np.concatenate([
        t0 + np.arange(span + 1),  # every step, incl. the exact halves
        t0 + rng.integers(0, span + 1, 300),
        np.zeros(64, np.int64),  # padding lanes
    ]).astype(np.int32)
    valid = np.ones(len(t), bool)
    valid[-64:] = False
    jmin, jmax = jdisp.time_bounds(jnp.asarray(t), jnp.asarray(valid))
    ref = jdisp._scale_time_int(jnp.asarray(t), jmin, jmax, scale)
    tmin, tmax = tdisp.time_bounds(_t(t), _t(valid))
    got = tdisp._scale_time_int(_t(t), tmin, tmax, scale)
    assert got.dtype == torch.int32
    _eq(got, ref)
    assert (got[-64:] < 0).all()  # the padding lanes went negative
    if span % 2 == 0 and scale % 2 == 1:
        # the half-way event is an exact tie: rounds to the even bin
        assert int(got[span // 2]) == 2 * round(scale / 4)


def test_scale_time_float():
    rng = np.random.default_rng(9)
    t = np.concatenate([rng.random(2000), np.linspace(0, 1, 1001)]).astype(np.float32)
    t[:5] = 0.0
    valid = rng.random(len(t)) < 0.9
    for scale in (89, 179, 1279):
        jmin, jmax = jdisp.time_bounds(jnp.asarray(t), jnp.asarray(valid))
        ref = jdisp._scale_time_float(jnp.asarray(t), jmin, jmax, scale)
        tmin, tmax = tdisp.time_bounds(_t(t), _t(valid))
        _eq(tdisp._scale_time_float(_t(t), tmin, tmax, scale), ref)


@pytest.mark.parametrize("float_t", [False, True], ids=["int_t", "float_t"])
def test_compute_event_disparity(rig, float_t):
    calib, cfg, jt, tt, events = rig
    if float_t:
        t = (events["t"] - events["t"][0]).astype(np.float32) / 16667.0
    else:
        t = events["t"]
    args = (events["x"], events["y"], t, events["p"])
    jb = JBatch.from_arrays(*args, CAPACITY)
    tb = TBatch.from_arrays(*args, CAPACITY, device="cpu")
    ref = jdisp.compute_event_disparity(
        jb, jt.cam_mapx_i16, jt.cam_mapy_i16, jt.x_map, t_px_scale=cfg.t_px_scale
    )
    got = tdisp.compute_event_disparity(
        tb, tt.cam_mapx_i16, tt.cam_mapy_i16, tt.x_map, t_px_scale=cfg.t_px_scale
    )
    for name in jdisp.DisparityResult._fields:
        _eq(getattr(got, name), getattr(ref, name))
    assert int(got.inlier.sum()) > 1000
    assert got.disp.dtype == torch.float32


def _kernel1_refs(rig, camera_view):
    """JAX per-event stage + packed scatter, shaped as kernel 1's outputs."""
    calib, cfg, jt, tt, events = rig
    jb = JBatch.from_structured(events, CAPACITY)
    res = jdisp.compute_event_disparity(
        jb, jt.cam_mapx_i16, jt.cam_mapy_i16, jt.x_map, t_px_scale=cfg.t_px_scale
    )
    if camera_view:
        window = (0, 0, cfg.camera_height, cfg.camera_width)
        ys, xs, H, W = jb.y, jb.x, cfg.camera_height, cfg.camera_width
    else:
        # an interior window, so that targets outside it are dropped
        window = (40, 60, cfg.rect_height - 90, cfg.rect_width - 130)
        ys, xs = res.y_rect, res.x_rect + res.disp.astype(jnp.int32)
        H, W = cfg.rect_height, cfg.rect_width
    packed = j_scatter(ys, xs, res.disp, res.inlier, height=H, width=W, window=window)
    return jb, res, np.asarray(packed).astype(np.int64), window


@pytest.mark.parametrize("camera_view", [False, True], ids=["projector", "camera"])
def test_kernel1_plain_matches_xla(rig, camera_view):
    calib, cfg, jt, tt, events = rig
    jb, res, packed_ref, (oy, ox, wh, ww) = _kernel1_refs(rig, camera_view)
    tb = TBatch.from_structured(events, CAPACITY, device="cpu")
    t_bin = tdisp.scale_time(tb.t, tb.valid, cfg.t_px_scale)
    _eq(t_bin, res.t_scaled)
    got = event_disparity_scatter(
        tb, t_bin, tt, camera_view=camera_view, window=(oy, ox),
        out_shape=(wh, ww), want_lanes=True,
    )
    assert got.packed_map.dtype == torch.int32
    np.testing.assert_array_equal(got.packed_map.numpy().astype(np.int64), packed_ref)
    assert int(got.num_inliers) == int(np.asarray(res.inlier).sum())
    for a, b in zip(got.lanes, (res.x_rect, res.y_rect, res.x_proj)):
        _eq(a, b)
    assert (packed_ref > 0).sum() > 500


@pytest.mark.parametrize("hbm", [False, True], ids=["vmem", "hbm"])
def test_kernel1_plain_lanes_match_pallas(rig, hbm):
    """Kernel 1's per-lane outputs (x_rect, y_rect, x_proj) equal the JAX
    Pallas gather kernels' (``rectify_and_lookup``, and the HBM-banded
    ``rectify_and_lookup_hbm``), run in interpret mode on arrival-order
    lanes, padding lanes included."""
    calib, cfg, jt, tt, events = rig
    jb = JBatch.from_structured(events, CAPACITY)
    t_min, t_max = jdisp.time_bounds(jb.t, jb.valid)
    jts = jdisp._scale_time_int(jb.t, t_min, t_max, cfg.t_px_scale)
    if hbm:
        plan = build_event_gather_hbm_plan(jt.cam_map_packed, np.asarray(jt.x_map), band_rows=64)
        ref = rectify_and_lookup_hbm(jb.x, jb.y, jts, plan, interpret=True)
    else:
        plan = build_event_gather_plan(jt.cam_map_packed, np.asarray(jt.x_map))
        ref = rectify_and_lookup(jb.x, jb.y, jts, plan, interpret=True)
    tb = TBatch.from_structured(events, CAPACITY, device="cpu")
    t_bin = tdisp.scale_time(tb.t, tb.valid, cfg.t_px_scale)
    got = event_disparity_scatter(
        tb, t_bin, tt, camera_view=False, window=(0, 0),
        out_shape=(cfg.rect_height, cfg.rect_width), want_lanes=True,
    )
    for a, b in zip(got.lanes, ref):
        _eq(a, b)


def test_kernel1_without_lanes(rig):
    calib, cfg, jt, tt, events = rig
    tb = TBatch.from_structured(events, CAPACITY, device="cpu")
    t_bin = tdisp.scale_time(tb.t, tb.valid, cfg.t_px_scale)
    kw = dict(camera_view=True, window=(0, 0), out_shape=(cfg.camera_height, cfg.camera_width))
    a = event_disparity_scatter(tb, t_bin, tt, **kw)
    b = event_disparity_scatter(tb, t_bin, tt, want_lanes=True, **kw)
    assert a.lanes is None
    assert torch.equal(a.packed_map, b.packed_map)
    assert torch.equal(a.num_inliers, b.num_inliers)


# -- kernel 1's staged entry (the 1-word batch of the streaming path) ---------


def _staged_words(rig, rng, layout):
    """(capacity,) uint32 words of the rig's events (x | y << bx | t_bin <<
    (bx + by), host bins) with the widths summing to 32: a quarter of the
    lanes get a time bin with its top bit set (bit 31 of the word, past
    the X-map), a tenth a row past the camera."""
    calib, cfg, jt, tt, events = rig
    n = min(len(events), CAPACITY)
    from xmaps_tpu_torch.io.prefetch import _scale_time_int_host

    ts = _scale_time_int_host(events["t"][:n], cfg.t_px_scale).astype(np.uint32)
    y = events["y"][:n].astype(np.uint32)
    high = rng.random(n) < 0.25
    ts[high] |= np.uint32(1 << (layout.bits_t - 1))
    y[rng.random(n) < 0.1] = (1 << layout.bits_y) - 1
    words = np.zeros(CAPACITY, np.uint32)
    words[:n] = (events["x"][:n].astype(np.uint32) | (y << layout.bits_x)
                 | (ts << (layout.bits_x + layout.bits_y)))
    words[n:] = rng.integers(0, 2**32, CAPACITY - n, dtype=np.uint64).astype(np.uint32)
    assert (words[:n] >> 31).any()
    return words


def _views(cfg, camera_view):
    if camera_view:
        return dict(camera_view=True, window=(0, 0),
                    out_shape=(cfg.camera_height, cfg.camera_width))
    return dict(camera_view=False, window=(40, 60),
                out_shape=(cfg.rect_height - 90, cfg.rect_width - 130))


@pytest.mark.parametrize("count", [0, 1777, CAPACITY], ids=["empty", "partial", "full"])
@pytest.mark.parametrize("camera_view", [False, True], ids=["projector", "camera"])
def test_staged_entry_plain_matches_array_entry(rig, count, camera_view):
    """Kernel 1's staged entry on the CPU (its plain version: the 1-word
    unpack, then the plain scatter) against the array entry's plain
    version on the same lanes decoded with numpy; the words fill 32 bits
    (bit 31 set), and lanes at and above the count hold random words."""
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter_staged,
        event_disparity_scatter_staged_plain,
    )
    from xmaps_tpu_torch.ops.staged import CompactLayout

    calib, cfg, jt, tt, events = rig
    layout = CompactLayout(7, 7, 18, cfg.t_px_scale)
    words = _staged_words(rig, np.random.default_rng(count), layout)
    kw = _views(cfg, camera_view)
    got = event_disparity_scatter_staged(_t(words.view(np.int32)), count, layout, tt, **kw)
    x = (words & 127).astype(np.int32)
    y = ((words >> 7) & 127).astype(np.int32)
    ts = (words >> 14).astype(np.int32)
    valid = np.arange(CAPACITY) < count
    batch = TBatch(_t(x), _t(y), _t(ts), torch.ones(CAPACITY, dtype=torch.int32), _t(valid),
                   torch.tensor(count, dtype=torch.int32))
    want = event_disparity_scatter(batch, _t(ts), tt, **kw)
    assert got.packed_map.dtype == torch.int32 and got.lanes is None
    assert torch.equal(got.packed_map, want.packed_map)
    assert int(got.num_inliers) == int(want.num_inliers)
    assert (int(got.num_inliers) > 500) == (count > 0)
    plain = event_disparity_scatter_staged_plain(_t(words.view(np.int32)), count, layout, tt,
                                                 **kw)
    assert torch.equal(plain.packed_map, got.packed_map)


@pytest.mark.parametrize("camera_view", [False, True], ids=["projector", "camera"])
def test_staged_entry_matches_jax(rig, camera_view):
    """The staged entry against the JAX package's 1-word unpack, per-event
    stage (host time bins) and packed scatter, at the rig's own layout."""
    from xmaps_tpu.io.prefetch import CompactLayout as JLayout
    from xmaps_tpu.io.prefetch import CompactStagedBatch as JStaged
    from xmaps_tpu.io.prefetch import unpack_staged_compact as j_unpack

    from xmaps_tpu_torch.io.prefetch import HostStagingPool
    from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter_staged
    from xmaps_tpu_torch.ops.staged import CompactLayout

    calib, cfg, jt, tt, events = rig
    layout = CompactLayout.for_pipeline(cfg)
    staged = HostStagingPool(CAPACITY, device="cpu", layout=layout).stage_compact(events)
    words, count = staged.word.numpy(), staged.count
    jb, jts = j_unpack(JStaged(jnp.asarray(words), count), JLayout(*layout))
    res = jdisp.compute_event_disparity(jb, jt.cam_mapx_i16, jt.cam_mapy_i16, jt.x_map,
                                        t_px_scale=cfg.t_px_scale, t_scaled=jts)
    kw = _views(cfg, camera_view)
    (oy, ox), (wh, ww) = kw["window"], kw["out_shape"]
    if camera_view:
        ys, xs, H, W = jb.y, jb.x, cfg.camera_height, cfg.camera_width
    else:
        ys, xs = res.y_rect, res.x_rect + res.disp.astype(jnp.int32)
        H, W = cfg.rect_height, cfg.rect_width
    want = j_scatter(ys, xs, res.disp, res.inlier, height=H, width=W, window=(oy, ox, wh, ww))
    got = event_disparity_scatter_staged(staged.word, count, layout, tt, **kw)
    np.testing.assert_array_equal(got.packed_map.numpy().view(np.uint32), np.asarray(want))
    assert int(got.num_inliers) == int(np.asarray(res.inlier).sum()) > 1000


def test_staged_entry_refuses_other_devices(rig):
    """The staged entry refuses a tensor neither on the CPU nor on CUDA."""
    from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter_staged
    from xmaps_tpu_torch.ops.staged import CompactLayout

    calib, cfg, jt, tt, events = rig
    word = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        event_disparity_scatter_staged(word, 3, CompactLayout(7, 7, 18, cfg.t_px_scale), tt,
                                       camera_view=True, window=(0, 0), out_shape=(4, 4))
