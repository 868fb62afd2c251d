"""``process_frames`` as one program over F frames (the port's group path)
against the JAX engine's ``process_frames`` and the port's ``process_frame``.

On the CPU the group path runs the group entries' plain versions: the
staging into one buffer (1 word an event, or the stacked ``EventBatch``),
the time binning over (F, capacity), the dedup filters frame by frame, then
kernel 1's, kernel 2's and kernel 3's group entries.  Every comparison is
exact.  The JAX engine runs its XLA chain (no Pallas), as
``tests/test_frame_pipeline.py`` runs its ``process_frames``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.ops import disparity as jdisp  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration  # noqa: E402
from xmaps_tpu.utils.synthetic import simulate_plane_events  # noqa: E402

from xmaps_tpu_torch.io import prefetch  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine as TEngine  # noqa: E402
from xmaps_tpu_torch.ops import cuda_events, cuda_tail, staged  # noqa: E402
from xmaps_tpu_torch.ops import disparity as tdisp  # noqa: E402
from xmaps_tpu_torch.ops.event_batch import EventBatch  # noqa: E402
from xmaps_tpu_torch.ops.frame_pipeline import group_depth_frames  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration as t_calib  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import with_events_outside_camera  # noqa: E402

torch.set_num_threads(1)

Z_NEAR, Z_FAR = 0.2, 1.2
CAPACITY = 2048
VIEWS = {"projector": False, "camera": True}
#: a rig whose camera (50 x 37: 1850 px, not a multiple of 4) and projector
#: (45 x 79: 3555 px, not a multiple of 8) leave ragged tails in every frame
ODD = dict(camera_width=50, camera_height=37, projector_width=45, projector_height=79)
FIELDS = ("frame_bgr", "depth", "disp_map", "num_inliers")


@functools.lru_cache(maxsize=None)
def _engines(camera_perspective, capacity=CAPACITY, sizes=()):
    kw = dict(event_capacity=capacity, z_near=Z_NEAR, z_far=Z_FAR,
              camera_perspective=camera_perspective)
    jeng = JEngine.from_calibration(make_synthetic_calibration(**dict(sizes)),
                                    use_pallas_tail=False, use_pallas_events=False, **kw)
    teng = TEngine.from_calibration(t_calib(**dict(sizes)), device="cpu", **kw)
    return jeng, teng


@functools.lru_cache(maxsize=None)
def _frames(n=5, sizes=()):
    """``n`` plane frames made from a seed: one empty, one over the
    capacity (truncated), the rest within it."""
    calib = make_synthetic_calibration(**dict(sizes))
    rng = np.random.default_rng(11)
    subsample = [0.05, 0.2, 0.1, 0.03, 0.08]
    frames = [
        simulate_plane_events(calib, depth_m=0.4 + 0.07 * i, subsample=subsample[i % 5],
                              jitter_us=2.0, rng=rng)
        for i in range(n)
    ]
    if n > 2:
        frames[2] = frames[2][:0]
    return tuple(frames)


def _float_t(frames):
    """The frames with their times normalised to float32 in [0, 1] (the
    offline eval's scan events)."""
    out = []
    for ev in frames:
        f = np.zeros(len(ev), dtype=[("x", "<i4"), ("y", "<i4"), ("t", "<f4"), ("p", "<i4")])
        for k in ("x", "y", "p"):
            f[k] = ev[k]
        if len(ev):
            t = ev["t"].astype(np.float64)
            f["t"] = (t - t.min()) / max(t.max() - t.min(), 1.0)
        out.append(f)
    return out


def _same(got, ref):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _same_as_frames(teng, frames, **kw):
    got = teng.process_frames(list(frames), **kw)
    assert len(got) == len(frames)
    for ev, g in zip(frames, got):
        _same(g, teng.process_frame(ev, **kw))
    return got


@pytest.mark.parametrize("n_frames", [1, 5])
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_process_frames_matches_jax_and_process_frame(view, n_frames):
    """Element by element equal to the JAX engine's ``process_frames`` and
    to the port's ``process_frame`` (an empty frame and one over the
    capacity among the five)."""
    jeng, teng = _engines(VIEWS[view])
    frames = list(_frames(n_frames))
    got = _same_as_frames(teng, frames)
    for g, r in zip(got, jeng.process_frames(frames)):
        _same(g, r)
    assert isinstance(teng.stage_group(frames), staged.CompactStagedGroup)


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("packed", [False, True], ids=["bgr", "packed"])
def test_process_frames_display_only(view, packed):
    _, teng = _engines(VIEWS[view])
    got = _same_as_frames(teng, _frames(), display_only=True, display_packed=packed)
    assert all(g.depth is None and g.disp_map is None for g in got)
    with pytest.raises(ValueError, match="display_only"):
        teng.process_frames(list(_frames()), display_packed=True)


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_process_frames_float_time(view):
    """Float timestamps take the array layout; equal to JAX and to
    ``process_frame``."""
    jeng, teng = _engines(VIEWS[view])
    frames = _float_t(_frames())
    assert isinstance(teng.stage_group(frames), EventBatch)
    got = _same_as_frames(teng, frames)
    for g, r in zip(got, jeng.process_frames(frames)):
        _same(g, r)


def _mixed():
    """Integer and float timestamps in one list: the float frame between
    two integer ones."""
    ints, floats = list(_frames()), _float_t(_frames())
    return [ints[0], floats[1], ints[3]]


def test_process_frames_refuses_mixed_time_kinds():
    """Integer and float timestamps in one list, as the JAX engine runs it:
    one group a time kind, the results in input order, each equal to JAX's
    ``process_frames`` and to the port's ``process_frame``, in both views,
    unfiltered and with ``first_per_xy``.  (The name is the one the test
    had while the port refused such a list; it is kept so that the test's
    history stays one test.)"""
    frames = _mixed()
    for view in sorted(VIEWS):
        jeng, teng = _engines(VIEWS[view])
        for name in ("none", "first_per_xy"):
            try:
                teng.set_frame_filter(name)
                jeng.set_frame_filter(name)
                got = _same_as_frames(teng, frames)
                for g, r in zip(got, jeng.process_frames(frames), strict=True):
                    _same(g, r)
            finally:
                teng.set_frame_filter("none")
                jeng.set_frame_filter("none")


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_process_frames_mixed_time_kinds_one_group_a_kind(view, monkeypatch):
    """A mixed list runs one group a time kind (the integer frames in one
    1-word group, the float frame in the array layout), display-packed
    too; a list of one kind stays one group."""
    _, teng = _engines(VIEWS[view])
    frames = _mixed()
    calls = []
    real = teng.stage_group

    def stage_group(group, **kw):
        calls.append(len(group))
        staged = real(group, **kw)
        calls.append(type(staged).__name__)
        return staged

    monkeypatch.setattr(teng, "stage_group", stage_group)
    _same_as_frames(teng, frames, display_only=True, display_packed=True)
    assert calls == [2, "CompactStagedGroup", 1, "EventBatch"]
    calls.clear()
    teng.process_frames(list(_frames()))
    assert calls == [5, "CompactStagedGroup"]


@pytest.mark.parametrize("name", ["first_per_xy", "first_per_yt"])
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_process_frames_dedup_filter(view, name):
    """A dedup filter runs frame by frame and the filtered batches and
    priorities go to kernel 1's group entry stacked; equal to JAX and to
    ``process_frame``."""
    jeng, teng = _engines(VIEWS[view])
    frames = list(_frames())
    try:
        teng.set_frame_filter(name)
        jeng.set_frame_filter(name)
        assert isinstance(teng.stage_group(frames), EventBatch)
        got = _same_as_frames(teng, frames)
        for g, r in zip(got, jeng.process_frames(frames)):
            _same(g, r)
    finally:
        teng.set_frame_filter("none")
        jeng.set_frame_filter("none")


def test_process_frames_events_outside_camera():
    """Events outside the layout's widths would wrap in a 1-word group: such
    a group takes the array layout and still equals ``process_frame``."""
    _, teng = _engines(False)
    rng = np.random.default_rng(3)
    frames = list(_frames())
    frames[1] = with_events_outside_camera(frames[1], rng, 64, 48)
    assert not prefetch.fits_layout(frames[1], teng.compact_layout)
    assert all(prefetch.fits_layout(ev, teng.compact_layout) for ev in _frames())
    assert isinstance(teng.stage_group(frames), EventBatch)
    _same_as_frames(teng, frames)


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_process_frames_capacity_and_strides_not_aligned(view):
    """Capacity 1000 (not a multiple of 32: kernel 1's warps straddle
    frames, handled by its per-frame sums) at a rig whose frames leave
    ragged tails (kernel 2's outputs then hold each frame at a padded
    stride); every frame equal to ``process_frame``."""
    sizes = tuple(sorted(ODD.items()))
    _, teng = _engines(VIEWS[view], 1000, sizes)
    for packed in (False, True):
        _same_as_frames(teng, _frames(5, sizes), display_only=packed, display_packed=packed)
    _same_as_frames(teng, _frames(5, sizes))


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_process_frames_forty_frames_capacity_1000_matches_jax(view):
    """Forty frames at capacity 1000 (on the card kernel 1's group entry
    then walks more lanes than its co-resident grid holds threads; here it
    runs its plain version), an empty frame and frames over the capacity
    among them: element by element equal to the JAX engine's
    ``process_frames`` and to the port's ``process_frame``."""
    jeng, teng = _engines(VIEWS[view], 1000)
    frames = list(_frames(40))
    assert sum(len(ev) > 1000 for ev in frames) >= 2 and len(frames[2]) == 0
    got = _same_as_frames(teng, frames)
    for g, r in zip(got, jeng.process_frames(frames)):
        _same(g, r)


def test_process_frames_empty_list():
    _, teng = _engines(False)
    assert teng.process_frames([]) == []


def test_group_depth_frames_is_stacked():
    """``group_depth_frames`` returns one result with a leading frame axis;
    ``process_frames`` returns views of its rows."""
    _, teng = _engines(False)
    frames = list(_frames())
    res = group_depth_frames(teng.stage_group(frames), teng.tables, teng.cfg, teng.plan,
                             layout=teng.compact_layout)
    assert res.frame_bgr.shape == (5, 160, 90, 3) and res.num_inliers.shape == (5,)
    assert int(res.num_inliers[2]) == 0
    with pytest.raises(ValueError, match="layout"):
        group_depth_frames(teng.stage_group(frames), teng.tables, teng.cfg, teng.plan)


# -- staging and binning ------------------------------------------------------


def test_stage_compact_group_rows_equal_stage_compact():
    """Row f of the group buffer and its count equal ``stage_compact`` of
    frame f; the F counts follow the rows in the same buffer."""
    _, teng = _engines(False)
    frames = list(_frames())
    layout = teng.compact_layout
    group = prefetch.stage_compact_group(frames, CAPACITY, layout, device="cpu")
    pool = prefetch.HostStagingPool(CAPACITY, device="cpu", layout=layout)
    assert group.word.shape == (5, CAPACITY) and group.counts.dtype == torch.int32
    assert group.word.untyped_storage().data_ptr() == group.counts.untyped_storage().data_ptr()
    for f, ev in enumerate(frames):
        one = pool.stage_compact(ev)
        assert torch.equal(group.word[f], one.word)
        assert group.host_counts[f] == int(group.counts[f]) == one.count == min(len(ev), CAPACITY)


def test_stack_structured_rows_equal_from_structured():
    frames = list(_frames())
    group = EventBatch.stack_structured(frames, CAPACITY, device="cpu")
    assert group.x.shape == (5, CAPACITY) and group.count.shape == (5,)
    for f, ev in enumerate(frames):
        one = EventBatch.from_structured(ev, CAPACITY, device="cpu")
        for a, b in zip(group.frame(f), one):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="integer and float"):
        EventBatch.stack_structured([frames[0], _float_t(frames)[1]], CAPACITY, device="cpu")


@pytest.mark.parametrize("floating", [False, True], ids=["int_t", "float_t"])
def test_scale_time_over_frames_matches_jax(floating):
    """Binning (F, capacity) at once equals JAX's binning of each row."""
    frames = _float_t(_frames()) if floating else list(_frames())
    group = EventBatch.stack_structured(frames, CAPACITY, device="cpu")
    t_min, t_max = tdisp.time_bounds(group.t, group.valid)
    assert t_min.shape == (5, 1)
    got = tdisp.scale_time(group.t, group.valid, 89)
    for f in range(5):
        t, v = jnp.asarray(group.t[f].numpy()), jnp.asarray(group.valid[f].numpy())
        jmin, jmax = jdisp.time_bounds(t, v)
        assert t_min[f, 0].item() == jmin.item()
        scale = jdisp._scale_time_float if floating else jdisp._scale_time_int
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(scale(t, jmin, jmax, 89)))


# -- the group entries' plain versions against the one-frame ones -------------


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_group_plain_versions_equal_per_frame_plain(view):
    """Each group entry's plain version (on CPU tensors the wrapper runs
    it) against its one-frame plain version on every frame."""
    _, teng = _engines(VIEWS[view])
    frames = list(_frames())
    cfg, plan, tables = teng.cfg, teng.plan, teng.tables
    if VIEWS[view]:
        kw = dict(camera_view=True, window=(0, 0), out_shape=(cfg.camera_height, cfg.camera_width))
        tail, tail_plain = cuda_tail.colorize_camera_group, cuda_tail.colorize_camera_plain
    else:
        kw = dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
                  out_shape=(plan.H, plan.W))
        tail, tail_plain = cuda_tail.tail_projector_group, cuda_tail.tail_projector_plain
    batch = EventBatch.stack_structured(frames, CAPACITY, device="cpu")
    t_bin = tdisp.scale_time(batch.t, batch.valid, cfg.t_px_scale)
    prio = torch.from_numpy(np.random.default_rng(2).permutation(
        5 * CAPACITY).reshape(5, CAPACITY) % CAPACITY).int()
    staged = prefetch.stage_compact_group(frames, CAPACITY, teng.compact_layout, device="cpu")
    for p in (None, prio):
        got = cuda_events.event_disparity_scatter_group(batch, t_bin, tables, priority=p, **kw)
        for f in range(5):
            one = cuda_events.event_disparity_scatter_plain(
                batch.frame(f), t_bin[f], tables, priority=None if p is None else p[f], **kw)
            assert torch.equal(got.packed_map[f], one.packed_map)
            assert torch.equal(got.num_inliers[f], one.num_inliers)
    got = cuda_events.event_disparity_scatter_staged_group(staged, teng.compact_layout, tables, **kw)
    for f in range(5):
        one = cuda_events.event_disparity_scatter_staged_plain(
            staged.word[f], staged.host_counts[f], teng.compact_layout, tables, **kw)
        assert torch.equal(got.packed_map[f], one.packed_map)
        assert torch.equal(got.num_inliers[f], one.num_inliers)
    for variant in (dict(emit_aux=True), dict(emit_aux=False),
                    dict(emit_aux=False, packed_bgr=True)):
        outs = tail(got.packed_map, tables, plan, **variant)
        for f in range(5):
            for a, b in zip(outs, tail_plain(got.packed_map[f], tables, plan, **variant)):
                assert (a is None and b is None) or torch.equal(a[f], b)


def test_group_entries_refuse_bad_shapes():
    _, teng = _engines(False)
    cfg, plan, tables = teng.cfg, teng.plan, teng.tables
    kw = dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
              out_shape=(plan.H, plan.W))
    one = EventBatch.from_structured(_frames()[0], CAPACITY, device="cpu")
    with pytest.raises(ValueError, match=r"\(F, capacity\)"):
        cuda_events.event_disparity_scatter_group(one, one.t, tables, **kw)
    staged = prefetch.stage_compact_group(list(_frames(2)), CAPACITY, teng.compact_layout,
                                          device="cpu")
    bad = staged._replace(host_counts=(1, CAPACITY + 1))
    with pytest.raises(ValueError, match="counts"):
        cuda_events.event_disparity_scatter_staged_group(bad, teng.compact_layout, tables, **kw)
    with pytest.raises(ValueError, match=r"\(F, "):
        cuda_tail.tail_projector_group(torch.zeros((plan.H, plan.W), dtype=torch.int32),
                                       tables, plan)


def test_group_outputs_keep_each_frame_aligned():
    """Kernel 2's group outputs: a frame every multiple of 8 pixels, views
    of the requested shape, each frame contiguous."""
    for shape in ((79, 45), (160, 90)):
        n = shape[0] * shape[1]
        stride = -(-n // 8) * 8
        for emit_aux, packed in ((True, False), (False, True), (False, False)):
            outs, ptrs, got_stride = cuda_tail._group_outputs(
                3, shape, torch.device("cpu"), emit_aux, packed)
            assert got_stride == stride
            for a in outs:
                if a is None:
                    continue
                assert a.shape[:3] == (3, *shape)
                step = a[1].data_ptr() - a[0].data_ptr()
                assert step == stride * a.element_size() * (3 if a.dim() == 4 else 1)
                assert step % 8 == 0 and a[1].is_contiguous()


# -- no default device ----------------------------------------------------------


def test_staging_classes_take_no_default_device():
    """``HostStagingPool`` and ``PacketRing`` run where the caller says, as
    every entry of the port: no default device."""
    with pytest.raises(TypeError, match="device"):
        prefetch.HostStagingPool(16)
    with pytest.raises(TypeError, match="device"):
        prefetch.PacketRing(packet_capacity=64)
    with pytest.raises(TypeError, match="device"):
        prefetch.stage_compact_group([], 16, None)
