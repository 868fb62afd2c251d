"""The port's multi-device scale-out (``xmaps_tpu_torch.parallel``) against
the JAX package's (``xmaps_tpu.parallel``) and the port's single-device
program.

On the CPU the mesh is ``["cpu"] * k``: k virtual devices, as the JAX
tests' 8 virtual CPU devices (``tests/conftest.py``).  Every shard runs
the kernels' plain versions and the collectives are the same torch ops
and copies as on the card.  Every comparison is exact.  The JAX engine
runs its XLA chain (no Pallas), as ``tests/test_sharding.py`` runs its
sharded pipeline.
"""

import contextlib
import functools
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_eval import _write_esl_yaml  # noqa: E402
from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.ops import disparity as jdisp  # noqa: E402
from xmaps_tpu.ops.event_batch import EventBatch as JBatch  # noqa: E402
from xmaps_tpu.ops.scatter import scatter_disp_packed as j_scatter  # noqa: E402
from xmaps_tpu.parallel import sharding as jshard  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration  # noqa: E402
from xmaps_tpu.utils.synthetic import simulate_plane_events  # noqa: E402

from xmaps_tpu_torch.apps import bench_scaling, eval_xmaps  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine as TEngine  # noqa: E402
from xmaps_tpu_torch.ops import _build, cuda_events  # noqa: E402
from xmaps_tpu_torch.ops import disparity as tdisp  # noqa: E402
from xmaps_tpu_torch.ops.event_batch import EventBatch  # noqa: E402
from xmaps_tpu_torch.ops.scatter import MAX_CAPACITY  # noqa: E402
from xmaps_tpu_torch.parallel import sharding  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration as t_calib  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
Z_NEAR, Z_FAR = 0.2, 1.2
#: ~1500 events a frame in 2048 lanes: every shard of 8 holds events, one
#: frame is over the capacity (truncated) and one is empty
CAPACITY = 2048
VIEWS = {"projector": False, "camera": True}
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
FILTERS = ["first_per_yt", "first_per_xy", "last_per_xy", "mean_first_last_per_xy"]


@functools.lru_cache(maxsize=None)
def _engines(camera_perspective):
    kw = dict(event_capacity=CAPACITY, z_near=Z_NEAR, z_far=Z_FAR,
              camera_perspective=camera_perspective)
    jeng = JEngine.from_calibration(make_synthetic_calibration(), use_pallas_tail=False,
                                    use_pallas_events=False, **kw)
    teng = TEngine.from_calibration(t_calib(), device="cpu", **kw)
    return jeng, teng


@functools.lru_cache(maxsize=None)
def _frames(n=8):
    """``n`` plane frames made from a seed: one empty (frame 2), one over
    the capacity (frame 1), the rest within it."""
    calib = make_synthetic_calibration()
    rng = np.random.default_rng(5)
    frames = [simulate_plane_events(calib, depth_m=0.42 + 0.05 * i,
                                    subsample=0.3 if i == 1 else 0.2, jitter_us=2.0, rng=rng)
              for i in range(n)]
    frames[2] = frames[2][:0]
    return tuple(frames)


@functools.lru_cache(maxsize=None)
def _jax_frames(view, name="none"):
    """JAX ``process_frame`` of each frame (numpy fields)."""
    jeng, _ = _engines(VIEWS[view])
    jeng.set_frame_filter(name)
    try:
        return [tuple(np.asarray(a) for a in jeng.process_frame(ev)) for ev in _frames()]
    finally:
        jeng.set_frame_filter("none")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, want, what=""):
    for k, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, (what, k)
            continue
        a, b = _np(a), _np(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} field {k}")


def _rows(res):
    """The frames of a stacked FrameResult."""
    return [type(res)(*(None if a is None else a[i] for a in res))
            for i in range(len(res.num_inliers))]


def _sharded(teng, frames, data, event):
    mesh = sharding.make_mesh(["cpu"] * (data * event), data=data, event=event)
    pipeline = sharding.make_sharded_pipeline(teng.cfg, teng.tables, mesh, teng.plan)
    return _rows(pipeline(sharding.shard_batches(
        [teng.make_batch(ev) for ev in frames], mesh, teng.cfg)))


def test_frames_fill_the_shards():
    """The test data reaches every shard of 8 and past the capacity."""
    counts = [len(ev) for ev in _frames()]
    assert counts[2] == 0 and counts[1] > CAPACITY
    assert min(c for i, c in enumerate(counts) if i != 2) > CAPACITY * 7 // 8


@pytest.mark.parametrize("data,event", SHAPES, ids=[f"{d}x{e}" for d, e in SHAPES])
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_sharded_matches_jax_depth_frame(view, data, event):
    """Every mesh shape on 8 virtual CPU devices: each frame equal to the
    JAX package's single-device program and to the port's."""
    _, teng = _engines(VIEWS[view])
    got = _sharded(teng, _frames(), data, event)
    for i, (g, ev) in enumerate(zip(got, _frames())):
        _same(g, _jax_frames(view)[i], f"frame {i} vs JAX")
        _same(g, teng.process_frame(ev), f"frame {i} vs process_frame")


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_sharded_matches_jax_sharded_pipeline(view):
    """The (4, 2) mesh against JAX's ``make_sharded_pipeline`` on its 8
    virtual CPU devices, field by field."""
    jeng, teng = _engines(VIEWS[view])
    assert len(jax.devices()) >= 8
    jmesh = jshard.make_mesh(jax.devices()[:8], data=4, event=2)
    jpipe = jshard.make_sharded_pipeline(jeng.cfg, jeng.tables, jmesh)
    batches = [JBatch.from_structured(ev, CAPACITY) for ev in _frames()]
    want = jpipe(jshard.shard_batches(batches, jmesh, jeng.cfg))
    got = _sharded(teng, _frames(), 4, 2)
    for i, g in enumerate(got):
        _same(g, [np.asarray(a)[i] for a in want], f"frame {i}")


@pytest.mark.parametrize("name", FILTERS)
def test_sharded_frame_filter_matches_jax(name):
    """The four dedup filters at (2, 4): the frame's lanes gathered onto
    the leader, filtered whole, each shard given its slice of the batch
    and of the global rank; equal to JAX and to ``process_frame``."""
    _, teng = _engines(False)
    teng.set_frame_filter(name)
    try:
        got = _sharded(teng, _frames(), 2, 4)
        for i, (g, ev) in enumerate(zip(got, _frames())):
            _same(g, _jax_frames("projector", name)[i], f"{name} frame {i} vs JAX")
            _same(g, teng.process_frame(ev), f"{name} frame {i} vs process_frame")
    finally:
        teng.set_frame_filter("none")


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_process_frames_sharded_matches_jax(view):
    """The JAX test's recipe: 6 frames on a 4-device data mesh (JAX pads
    two empty frames; the port's last block is short and its last row
    empty), against JAX's ``process_frames_sharded`` and the port's
    ``process_frame``; the tables are replicated once (a virtual mesh of
    one device holds the engine's own)."""
    jeng, teng = _engines(VIEWS[view])
    frames = list(_frames(6))
    want = jeng.process_frames_sharded(frames, jshard.make_mesh(jax.devices()[:4], data=4))
    mesh = sharding.make_mesh(["cpu"] * 4, data=4)
    got = teng.process_frames_sharded(frames, mesh)
    assert len(got) == len(want) == 6
    for i, (g, w, ev) in enumerate(zip(got, want, frames)):
        _same(g, [np.asarray(a) for a in w], f"frame {i} vs JAX")
        _same(g, teng.process_frame(ev), f"frame {i} vs process_frame")
    packed = teng.process_frames_sharded(frames, mesh, display_only=True, display_packed=True)
    for i, (g, ev) in enumerate(zip(packed, frames)):
        _same(g, teng.process_frame(ev, display_only=True, display_packed=True), f"packed {i}")
    replica = teng._replicas[torch.device("cpu")][0]
    assert replica.x_map is teng.tables.x_map
    assert teng.process_frames_sharded([], mesh) == []


def test_process_frames_sharded_uneven_blocks_and_filter():
    """7 frames at data 4 (blocks of 2, 2, 2, 1), a filter set after a
    first call (a pipeline a config), and the refusal of an event axis."""
    _, teng = _engines(False)
    frames = list(_frames(7))
    mesh = sharding.make_mesh(["cpu"] * 4)
    assert [s.stop - s.start for s in sharding.split_frames(7, 4)] == [2, 2, 2, 1]
    assert [s.stop - s.start for s in sharding.split_frames(5, 4)] == [2, 2, 1, 0]
    for name in ("none", "first_per_xy"):
        teng.set_frame_filter(name)
        try:
            for i, (g, ev) in enumerate(zip(teng.process_frames_sharded(frames, mesh), frames)):
                _same(g, teng.process_frame(ev), f"{name} frame {i}")
        finally:
            teng.set_frame_filter("none")
    with pytest.raises(ValueError, match="event == 1"):
        teng.process_frames_sharded(frames, sharding.make_mesh(["cpu"] * 4, event=2))


def _float_t(ev):
    """The frame with its times normalised to float32 in [0, 1] (the
    offline eval's scan events)."""
    f = np.zeros(len(ev), dtype=[("x", "<i4"), ("y", "<i4"), ("t", "<f4"), ("p", "<i4")])
    for k in ("x", "y", "p"):
        f[k] = ev[k]
    t = ev["t"].astype(np.float64)
    f["t"] = (t - t.min()) / max(t.max() - t.min(), 1.0)
    return f


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_process_frames_sharded_mixed_time_kinds(view, monkeypatch):
    """Integer and float timestamps in one list at data 2: the JAX engine
    runs it (its stacking makes every time float), and so does the port,
    one group a time kind on each row whose block holds it, each frame on
    the row its position gives it; every element equal to JAX's and to
    ``process_frame``, unfiltered and with ``first_per_xy``."""
    jeng, teng = _engines(VIEWS[view])
    fr = _frames()
    frames = [fr[0], _float_t(fr[1]), fr[3], _float_t(fr[4]), fr[2]]
    want = jeng.process_frames_sharded(frames, jshard.make_mesh(jax.devices()[:2], data=2))
    mesh = sharding.make_mesh(["cpu"] * 2, data=2)
    blocks = []
    real = teng.stage_group

    def stage_group(block, **kw):
        blocks.append([int(ev["t"].dtype.kind == "f") for ev in block])
        return real(block, **kw)

    monkeypatch.setattr(teng, "stage_group", stage_group)
    got = teng.process_frames_sharded(frames, mesh)
    # rows [0, 1, 2] and [3, 4]: the integer frames (0, 2 | 4), then the float ones (1 | 3)
    assert blocks == [[0, 0], [0], [1], [1]]
    assert len(got) == len(want) == 5
    for i, (g, w, ev) in enumerate(zip(got, want, frames)):
        _same(g, [np.asarray(a) for a in w], f"frame {i} vs JAX")
        _same(g, teng.process_frame(ev), f"frame {i} vs process_frame")
    teng.set_frame_filter("first_per_xy")
    try:
        for i, (g, ev) in enumerate(zip(teng.process_frames_sharded(frames, mesh), frames)):
            _same(g, teng.process_frame(ev), f"first_per_xy frame {i}")
    finally:
        teng.set_frame_filter("none")


def test_group_pipeline_rows_stay_on_their_rows():
    """``make_group_sharded_pipeline`` returns one result a non-empty row,
    a group staged on another mesh is refused."""
    _, teng = _engines(False)
    mesh = sharding.make_mesh(["cpu"] * 3)
    group = sharding.shard_staged_group(list(_frames(4)), mesh, teng.stage_group)
    assert group.rows[2] is None and [r.word.shape[0] for r in group.rows[:2]] == [2, 2]
    pipe = sharding.make_group_sharded_pipeline(teng.cfg, teng.tables, mesh, teng.plan,
                                                layout=teng.compact_layout)
    rows = pipe(group)
    assert [len(r.num_inliers) for r in rows] == [2, 2]
    other = sharding.make_group_sharded_pipeline(teng.cfg, teng.tables,
                                                 sharding.make_mesh(["cpu"] * 2), teng.plan)
    with pytest.raises(ValueError, match="another mesh"):
        other(group)


# -- kernel 1's lane offset, the bounds, the collectives ---------------------


def _scatter_inputs():
    _, teng = _engines(False)
    batch = teng.make_batch(_frames()[0])
    t_bin = tdisp.scale_time(batch.t, batch.valid, teng.cfg.t_px_scale)
    return teng, batch, t_bin, sharding.scatter_view(teng.cfg, teng.plan)


@pytest.mark.parametrize("offset", [0, 1000, MAX_CAPACITY - CAPACITY])
def test_kernel1_plain_index_offset_matches_jax(offset):
    """Kernel 1's plain version (and its group entry's) with a lane offset
    against JAX's ``scatter_disp_packed(index_offset=)``: offset 0 is
    today's result; at the largest offset the keys pass 2**31."""
    teng, batch, t_bin, view = _scatter_inputs()
    got = cuda_events.event_disparity_scatter(batch, t_bin, teng.tables, **view,
                                              index_offset=offset)
    tb = JBatch(*(jnp.asarray(a.numpy()) for a in batch))
    res = jdisp.compute_event_disparity(tb, teng.tables.cam_mapx_i16.numpy(),
                                        teng.tables.cam_mapy_i16.numpy(),
                                        teng.tables.x_map.numpy(), t_px_scale=0,
                                        t_scaled=jnp.asarray(t_bin.numpy()))
    oy, ox = view["window"]
    want = j_scatter(res.y_rect - oy, res.x_rect + res.disp.astype(jnp.int32) - ox, res.disp,
                     res.inlier, height=view["out_shape"][0], width=view["out_shape"][1],
                     index_offset=offset)
    np.testing.assert_array_equal(got.packed_map.numpy().view(np.uint32), np.asarray(want))
    if offset == 0:
        plain = cuda_events.event_disparity_scatter(batch, t_bin, teng.tables, **view)
        assert torch.equal(got.packed_map, plain.packed_map)
    if offset == MAX_CAPACITY - CAPACITY:
        assert (got.packed_map < 0).any()  # words of 2**31 and above
    group = EventBatch(*(torch.stack([a, a]) for a in batch))
    g = cuda_events.event_disparity_scatter_group(group, torch.stack([t_bin, t_bin]),
                                                  teng.tables, **view, index_offset=offset)
    assert torch.equal(g.packed_map[1], got.packed_map)
    assert torch.equal(g.num_inliers[0], got.num_inliers)


def test_kernel1_index_offset_refused_past_the_packing():
    teng, batch, t_bin, view = _scatter_inputs()
    for offset in (-1, MAX_CAPACITY - CAPACITY + 1):
        with pytest.raises(ValueError, match="overflow the uint32"):
            cuda_events.event_disparity_scatter(batch, t_bin, teng.tables, **view,
                                                index_offset=offset)
    group = EventBatch(*(a[None] for a in batch))
    with pytest.raises(ValueError, match="overflow the uint32"):
        cuda_events.event_disparity_scatter_group(group, t_bin[None], teng.tables, **view,
                                                  index_offset=MAX_CAPACITY)


def test_event_shards_combine_into_the_frame():
    """Kernel 1 on each lane shard with its offset and the frame's bounds,
    combined by the unsigned max: the frame's map and count."""
    teng, batch, _, view = _scatter_inputs()
    whole = cuda_events.event_disparity_scatter(
        batch, tdisp.scale_time(batch.t, batch.valid, teng.cfg.t_px_scale), teng.tables,
        **view)
    bounds = tdisp.time_bounds(batch.t, batch.valid)
    parts = []
    for s in range(4):
        sl = slice(s * CAPACITY // 4, (s + 1) * CAPACITY // 4)
        shard = EventBatch(*(a[sl] for a in batch[:5]), count=batch.count)
        t_bin = tdisp.scale_time(shard.t, shard.valid, teng.cfg.t_px_scale, bounds=bounds)
        parts.append(cuda_events.event_disparity_scatter(shard, t_bin, teng.tables, **view,
                                                         index_offset=sl.start))
    cpu = torch.device("cpu")
    assert torch.equal(sharding.pmax_u32([p.packed_map for p in parts], cpu), whole.packed_map)
    assert torch.equal(sharding.psum([p.num_inliers for p in parts], cpu), whole.num_inliers)


@pytest.mark.parametrize("floating", [False, True], ids=["int_t", "float_t"])
def test_scale_time_given_bounds_matches_jax(floating):
    """``scale_time(bounds=)``: a shard of a frame binned with the frame's
    bounds equals JAX's binning of those lanes with them, and the slice of
    the whole frame's bins; without bounds, today's result; group bounds
    (F, 1)."""
    frames = list(_frames(4))
    if floating:
        for k, ev in enumerate(frames):
            f = np.zeros(len(ev), dtype=[("x", "<i4"), ("y", "<i4"), ("t", "<f4"), ("p", "<i4")])
            for key in ("x", "y", "p"):
                f[key] = ev[key]
            if len(ev):
                t = ev["t"].astype(np.float64)
                f["t"] = (t - t.min()) / max(t.max() - t.min(), 1.0)
            frames[k] = f
    group = EventBatch.stack_structured(frames, CAPACITY, device="cpu")
    whole = tdisp.scale_time(group.t, group.valid, 89)
    bounds = tdisp.time_bounds(group.t, group.valid)
    assert bounds[0].shape == (4, 1)
    assert torch.equal(tdisp.scale_time(group.t, group.valid, 89, bounds=bounds), whole)
    sl = slice(CAPACITY // 2, CAPACITY)
    part = tdisp.scale_time(group.t[:, sl], group.valid[:, sl], 89, bounds=bounds)
    assert torch.equal(part, whole[:, sl])
    scale = jdisp._scale_time_float if floating else jdisp._scale_time_int
    for f in range(4):
        t = jnp.asarray(group.t[f, sl].numpy())
        jmin, jmax = jdisp.time_bounds(jnp.asarray(group.t[f].numpy()),
                                       jnp.asarray(group.valid[f].numpy()))
        assert bounds[0][f, 0].item() == jmin.item() and bounds[1][f, 0].item() == jmax.item()
        np.testing.assert_array_equal(part[f].numpy(), np.asarray(scale(t, jmin, jmax, 89)))
    one = tdisp.scale_time(group.t[0, sl], group.valid[0, sl], 89,
                           bounds=tuple(b[0, 0] for b in bounds))
    assert torch.equal(one, whole[0, sl])


def test_pmax_u32_is_the_unsigned_max():
    """Words on both sides of 2**31 (negative as int32): the unsigned max,
    as JAX's ``pmax`` on uint32; the shards' tensors are left as they were
    (on a virtual mesh the leader's copy is the shard itself)."""
    rng = np.random.default_rng(2)
    words = [rng.integers(0, 2**32, (5, 7), dtype=np.uint64).astype(np.uint32)
             for _ in range(3)]
    words[1][0, :] = [0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 7]
    words[0][0, :] = [2**31, 2**31 - 1, 0, 2**31 - 1, 2**32 - 1, 2**31, 2**31]
    parts = [torch.from_numpy(w.view(np.int32).copy()) for w in words]
    before = [p.clone() for p in parts]
    got = sharding.pmax_u32(parts, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.maximum.reduce(words))
    assert not torch.equal(got, torch.maximum(torch.maximum(parts[0], parts[1]), parts[2]))
    for p, b in zip(parts, before):
        assert torch.equal(p, b)
    assert sharding.pmax_u32(parts[:1], "cpu") is not parts[0]


def test_collectives():
    parts = [torch.tensor([[3], [-1]]), torch.tensor([[1], [5]])]
    cpu = torch.device("cpu")
    assert sharding.pmin(parts, cpu).tolist() == [[1], [-1]]
    assert sharding.pmax(parts, cpu).tolist() == [[3], [5]]
    assert sharding.psum(parts, cpu).tolist() == [[4], [4]]
    assert sharding.all_gather(parts, cpu).tolist() == [[3, 1], [-1, 5]]


# -- the mesh, placement, the device guard -------------------------------------


def test_make_mesh_shapes():
    mesh = sharding.make_mesh(["cpu"] * 8, data=4, event=2)
    assert mesh.shape == {"data": 4, "event": 2}
    assert mesh.devices.shape == (4, 2) and mesh.virtual
    assert mesh.distinct == [torch.device("cpu")]
    assert sharding.make_mesh(["cpu"] * 8, event=4).shape == {"data": 2, "event": 4}
    assert sharding.make_mesh(["cpu"]).shape == {"data": 1, "event": 1}
    assert not sharding.make_mesh(["cpu"]).virtual
    for kw in (dict(data=3), dict(data=2, event=2), dict(event=3)):
        with pytest.raises(ValueError, match="devices"):
            sharding.make_mesh(["cpu"] * 8, **kw)
    with pytest.raises(ValueError, match="no devices"):
        sharding.make_mesh([])
    with pytest.raises(ValueError, match="unsupported"):
        sharding.make_mesh(["meta"])


def test_make_mesh_refuses_cards_that_are_not_there(monkeypatch):
    """A ``cuda:i`` past the visible cards raises; nothing lands on the CPU
    unless "cpu" is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for names in (["cuda:0"], ["cuda"], ["cuda:0", "cuda:1"], ["cpu", "cuda:3"]):
        with pytest.raises(ValueError, match="not there"):
            sharding.make_mesh(names)


def test_shard_batches_places_blocks_and_refuses_bad_shapes():
    _, teng = _engines(False)
    batches = [teng.make_batch(ev) for ev in _frames(4)]
    mesh = sharding.make_mesh(["cpu"] * 4, data=2, event=2)
    placed = sharding.shard_batches(batches, mesh, teng.cfg)
    assert len(placed.shards) == 2 and len(placed.shards[0]) == 2
    shard = placed.shards[1][1]
    assert shard.x.shape == (2, CAPACITY // 2) and shard.x.is_contiguous()
    assert torch.equal(shard.x[0], batches[2].x[CAPACITY // 2:])
    assert torch.equal(shard.count, torch.stack([b.count for b in batches[2:]]))
    with pytest.raises(ValueError, match="data rows"):
        sharding.shard_batches(batches[:3], mesh, teng.cfg)
    with pytest.raises(ValueError, match="event shards"):
        sharding.shard_batches(batches, sharding.make_mesh(["cpu"] * 3, event=3), teng.cfg)
    pipe = sharding.make_sharded_pipeline(teng.cfg, teng.tables, mesh, teng.plan)
    other = sharding.shard_batches(batches, sharding.make_mesh(["cpu"] * 4), teng.cfg)
    with pytest.raises(ValueError, match="another mesh"):
        pipe(other)


def test_every_launch_goes_through_the_device_guard(monkeypatch):
    """``_build.launch`` calls the C entry with the device of the tensors
    current and its stream appended, checks its error and counts; and no
    wrapper calls the library but through it."""
    calls, current = [], []

    class FakeLib:
        def warmup_add_one(self, *args):
            calls.append((current[-1] if current else None, args))
            return 0

        def tile_store_last(self, *args):
            return 700

    @contextlib.contextmanager
    def device(dev):
        current.append(dev)
        yield
        current.pop()

    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(_build, "load", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    before = _build.LAUNCHES["warmup_add_one"]
    _build.launch(torch.device("cuda", 1), "warmup_add_one", "warmup_add_one", 5, 6)
    assert calls == [(torch.device("cuda", 1), (5, 6, 1234))]
    assert _build.LAUNCHES["warmup_add_one"] == before + 1
    with pytest.raises(RuntimeError, match="tile_store_last failed: cudaError 700"):
        _build.launch(torch.device("cuda", 0), "tile_store_last", "tile_store_last")
    ops = REPO / "xmaps_tpu_torch" / "ops"
    sites = 0
    for path in ops.glob("*.py"):
        src = path.read_text()
        if path.name != "_build.py":
            assert "_build.load()" not in src and "cuda_stream" not in src, path.name
            sites += src.count("_build.launch(")
    assert sites == 18


# -- the apps ------------------------------------------------------------------


def test_eval_xmaps_devices_2_writes_the_same_npy(tmp_path):
    """``eval_xmaps -device cpu -devices 2`` (2 virtual CPU devices; 3
    scans, so the trailing group is padded) writes each depth ``.npy``
    byte-equal to ``-devices 1``."""
    calib = make_synthetic_calibration(baseline=3.0, camera_width=96, camera_height=72,
                                       projector_width=45, projector_height=80)
    yaml_path = str(tmp_path / "calib.yaml")
    _write_esl_yaml(yaml_path, calib)
    for run in ("one", "two"):
        scans = tmp_path / run / "scans_np"
        scans.mkdir(parents=True)
        for i, z in enumerate((30.0, 33.0, 36.0)):
            ev = simulate_plane_events(calib, depth_m=z, scan_upwards=False)
            img = np.zeros((72, 96))
            img[ev["y"], ev["x"]] = (ev["t"] + 1) / (ev["t"].max() + 1)
            np.save(scans / f"scan{i:03d}.npy", img)
    args = ["-proj_height", "80", "-proj_width", "45", "-calib", yaml_path, "-num_scans", "3",
            "-cam_width", "96", "-cam_height", "72", "-device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert eval_xmaps.main(["-object_dir", str(tmp_path / "one")] + args) == 0
        assert eval_xmaps.main(["-object_dir", str(tmp_path / "two"), "-devices", "2"]
                               + args) == 0
    assert "on 2 devices" in out.getvalue()
    for i in range(3):
        name = Path("x_maps/depth_init") / f"scans{i:03d}.npy"
        one, two = (tmp_path / run / name for run in ("one", "two"))
        assert one.read_bytes() == two.read_bytes(), name
        d = np.load(one)
        assert (d > 0).sum() > 100
    for i in range(3):
        ply = Path("x_maps/pointcloud_init") / f"scans{i:03d}.ply"
        assert (tmp_path / "one" / ply).read_bytes() == (tmp_path / "two" / ply).read_bytes()


def test_bench_scaling_cpu_smoke():
    """``apps.bench_scaling --device cpu --virtual 4`` at a small rig: one
    JSON line with the JAX script's keys, every shape timed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench_scaling.main(["--device", "cpu", "--virtual", "4", "--camera", "64", "48",
                                   "--projector", "90", "160"]) == 0
    doc = json.loads(out.getvalue().strip().splitlines()[-1])
    assert doc["virtual"] is True and doc["devices"] == ["cpu"] and doc["card"] is None
    assert sorted(doc["results"]) == ["1x1", "1x2", "1x4", "2x1", "2x2", "4x1"]
    assert sorted(doc["group_live_path"]["results"]) == ["1x1", "2x1", "4x1"]
    for res in (doc["results"], doc["group_live_path"]["results"]):
        assert res["1x1"]["weak_scaling_eff"] == 1.0
        for k, v in res.items():
            assert v["frames_per_step"] == bench_scaling.FRAMES_PER_ROW * int(k.split("x")[0])
            assert v["step_ms"] > 0 and v["frame_ms"] > 0 and v["weak_scaling_eff"] > 0
            assert v["device_step_ms"] is None
    assert bench_scaling.mesh_shapes(4) == [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2), (1, 4)]
    assert {(8, 1), (4, 2), (2, 4), (1, 8)} <= set(bench_scaling.mesh_shapes(8))


def test_bench_scaling_steps_and_out(tmp_path):
    """``--steps`` sets the timed steps a shape (the JAX script's flag) and
    ``--out`` writes the printed JSON line to a file as well."""
    path = tmp_path / "scaling.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench_scaling.main(["--device", "cpu", "--virtual", "2", "--camera", "64", "48",
                                   "--projector", "90", "160", "--steps", "3",
                                   "--out", str(path)]) == 0
    line = out.getvalue().strip().splitlines()[-1]
    assert path.read_text() == line + "\n"
    doc = json.loads(line)
    assert doc["timing"]["wall"] == "host clock + synchronize, median of 3 steps"
    assert sorted(doc["results"]) == ["1x1", "1x2", "2x1"]
    with pytest.raises(ValueError, match="--steps 0"):
        bench_scaling.main(["--device", "cpu", "--steps", "0"])


def test_parallel_imports_no_jax():
    """``xmaps_tpu_torch.parallel`` and the two new entry points import
    nothing of JAX or of the JAX package, in a fresh interpreter."""
    code = """
import sys
import xmaps_tpu_torch.parallel
import xmaps_tpu_torch.apps.bench_scaling
import xmaps_tpu_torch.apps.eval_xmaps
from xmaps_tpu_torch.parallel import make_mesh
make_mesh(["cpu"] * 2)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "xmaps_tpu"))
assert not loaded, loaded
print("no-jax-ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "no-jax-ok"
