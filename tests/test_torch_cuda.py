"""The CUDA kernels on the card vs their plain PyTorch versions (small rigs).

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
false.  On a machine with an NVIDIA GPU (sm_90a, nvcc on PATH or under
/usr/local/cuda) run them with

    python -m pytest tests/test_torch_cuda.py -m gpu -q

These tests import nothing of JAX; the CPU tests hold the plain versions
against the JAX package.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine  # noqa: E402
from xmaps_tpu_torch.ops import _build  # noqa: E402
from xmaps_tpu_torch.ops.cuda_events import (  # noqa: E402
    event_disparity_scatter,
    event_disparity_scatter_plain,
)
from xmaps_tpu_torch.ops.cuda_tail import (  # noqa: E402
    colorize_camera,
    colorize_camera_plain,
    tail_projector,
    tail_projector_plain,
)
from xmaps_tpu_torch.ops.disparity import scale_time  # noqa: E402
from xmaps_tpu_torch.ops.event_batch import EventBatch  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import (  # noqa: E402
    make_synthetic_calibration,
    simulate_plane_events,
)

pytestmark = pytest.mark.gpu

SIZES = dict(camera_width=128, camera_height=96, projector_width=180, projector_height=320)
VARIANTS = [
    dict(emit_aux=True, packed_bgr=False),
    dict(emit_aux=False, packed_bgr=False),
    dict(emit_aux=False, packed_bgr=True),
]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    _build.load()
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _engine(camera_perspective):
    return XMapsDepthEngine.from_calibration(
        make_synthetic_calibration(**SIZES), device="cuda", event_capacity=4096,
        z_near=0.2, z_far=1.2, camera_perspective=camera_perspective,
    )


def _frames():
    calib = make_synthetic_calibration(**SIZES)
    rng = np.random.default_rng(5)
    return [
        simulate_plane_events(calib, depth_m=d, subsample=s, jitter_us=2.0, rng=rng)
        for d, s in ((0.5, 0.03), (0.7, 0.1))
    ]


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_kernels_match_plain_on_card(cuda, camera_perspective):
    eng = _engine(camera_perspective)
    cfg, plan = eng.cfg, eng.plan
    if camera_perspective:
        kw = dict(camera_view=True, window=(0, 0), out_shape=(cfg.camera_height, cfg.camera_width))
        tail, tail_plain = colorize_camera, colorize_camera_plain
    else:
        kw = dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
                  out_shape=(plan.H, plan.W))
        tail, tail_plain = tail_projector, tail_projector_plain
    for ev in _frames():
        batch = eng.make_batch(ev)
        t_bin = scale_time(batch.t, batch.valid, cfg.t_px_scale)
        got = event_disparity_scatter(batch, t_bin, eng.tables, want_lanes=True, **kw)
        ref = event_disparity_scatter_plain(batch, t_bin, eng.tables, want_lanes=True, **kw)
        torch.cuda.synchronize()
        _equal(got.packed_map, ref.packed_map)
        _equal(got.num_inliers, ref.num_inliers)
        for a, b in zip(got.lanes, ref.lanes):
            _equal(a, b)
        for variant in VARIANTS:
            for a, b in zip(tail(ref.packed_map, eng.tables, plan, **variant),
                            tail_plain(ref.packed_map, eng.tables, plan, **variant)):
                _equal(a, b)


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_engine_on_card_matches_cpu(cuda, camera_perspective):
    eng = _engine(camera_perspective)
    cpu = eng.to("cpu")
    frames = _frames()
    _build.reset_launch_counts()
    outs = eng.process_frames(frames)
    torch.cuda.synchronize()
    tail = "colorize_camera" if camera_perspective else "tail_projector"
    assert _build.LAUNCHES["event_disparity_scatter"] == len(frames)
    assert _build.LAUNCHES[tail] == len(frames)
    for got, ref in zip(outs, cpu.process_frames(frames)):
        assert got.frame_bgr.device.type == "cuda"
        for name in ("frame_bgr", "depth", "disp_map", "num_inliers"):
            _equal(getattr(got, name), getattr(ref, name))


def test_wrappers_check_inputs(cuda):
    eng = _engine(False)
    plan = eng.plan
    with pytest.raises(ValueError, match="packed_crop"):
        tail_projector(torch.zeros((plan.H + 1, plan.W), dtype=torch.int32, device=cuda),
                       eng.tables, plan)
    with pytest.raises(ValueError, match="packed_crop"):
        tail_projector(torch.zeros((plan.H, plan.W), dtype=torch.float32, device=cuda),
                       eng.tables, plan)


# -- kernel 1 at the offline eval's capacity, kernels A and B ----------------


def test_event_scatter_at_eval_capacity(cuda):
    """Kernel 1 at capacity 307200 (the eval's 640 x 480 batch): 300000
    events on a 128x96 camera, so lanes above 262143 win most pixels; the
    packed uint32 words equal the plain version's."""
    capacity, n = 307200, 300000
    eng = XMapsDepthEngine.from_calibration(
        make_synthetic_calibration(**SIZES), device="cuda", event_capacity=capacity,
        camera_perspective=True,
    )
    rng = np.random.default_rng(3)
    x, y = rng.integers(0, 128, n), rng.integers(0, 96, n)
    t = rng.random(n).astype(np.float32)
    batch = EventBatch.from_arrays(x, y, t, np.ones(n), capacity, device="cuda")
    t_bin = scale_time(batch.t, batch.valid, eng.cfg.t_px_scale)
    kw = dict(camera_view=True, window=(0, 0), out_shape=(96, 128))
    got = event_disparity_scatter(batch, t_bin, eng.tables, **kw)
    ref = event_disparity_scatter_plain(batch, t_bin, eng.tables, **kw)
    torch.cuda.synchronize()
    _equal(got.packed_map, ref.packed_map)
    _equal(got.num_inliers, ref.num_inliers)
    words = got.packed_map.cpu().numpy().view(np.uint32)
    # ~10 inliers a pixel: the winner is a lane above 262143 (the top 15%)
    # at most pixels (0.82 on the card)
    assert (words[words > 0] // 8192 - 1 > 262143).mean() > 0.5
    cpu = eng.to("cpu")
    out = eng.process_batch_device(batch)
    ref_out = cpu.process_batch_device(EventBatch(*(a.cpu() for a in batch)))
    for name in ("frame_bgr", "depth", "disp_map", "num_inliers"):
        _equal(getattr(out, name), getattr(ref_out, name))


def _monotone_case(seed, H, W, occupancy):
    rng = np.random.default_rng(seed)
    base = np.sort(rng.random((H, W)).astype(np.float32), axis=1)
    base = np.round(base * 60) / 60  # plateaus and exact ties
    proj = np.where(rng.random((H, W)) < 0.2, base + 1e-3, 0).astype(np.float32)
    cam = np.zeros((H, W), np.float32)
    r0, r1, c0, c1 = occupancy
    blob = rng.random((r1 - r0, c1 - c0)).astype(np.float32)
    cam[r0:r1, c0:c1] = np.where(blob < 0.4, blob, 0)
    cam[r0, c0:c0 + 40] = proj[r0, c0 + 17:c0 + 57]  # exact value matches
    return cam, proj


@pytest.mark.parametrize("W", [420, 548], ids=["frame_edge", "inner_edge"])
def test_esl_search_kernel_matches_plain_on_card(cuda, W):
    from xmaps_tpu_torch.ops.esl_search import esl_disparity_search, esl_search_prep

    cam, proj = _monotone_case(W, 48, W, (11, 37, 70, 300))
    kw = dict(min_disp=5, max_disp=200, row_range=(11, 37), col_range=(70, 300))
    want = esl_disparity_search(torch.from_numpy(cam), torch.from_numpy(proj), **kw)
    prep = esl_search_prep(torch.from_numpy(proj).cuda(), **kw)
    _build.reset_launch_counts()
    got = esl_disparity_search(torch.from_numpy(cam).cuda(), None, prep=prep, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["esl_disparity_search"] == 1
    _equal(got, want)
    assert want.any()


@pytest.mark.parametrize("with_inb", [False, True])
def test_remap_gather_matches_plain_on_card(cuda, with_inb):
    from xmaps_tpu_torch.ops.remap import build_remap_indices, remap_gather

    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.random((48, 64)).astype(np.float32))
    map_x = (rng.random((120, 200)) * 64 * 1.2 - 4).astype(np.float32)
    map_y = (rng.random((120, 200)) * 48 * 1.2 - 4).astype(np.float32)
    yi, xi, inb = (torch.from_numpy(a) for a in build_remap_indices(map_x, map_y, (48, 64)))
    mask = inb if with_inb else None
    want = remap_gather(src, yi, xi, mask)
    got = remap_gather(src.cuda(), yi.cuda(), xi.cuda(), None if mask is None else mask.cuda())
    torch.cuda.synchronize()
    _equal(got, want)


def test_device_depth_init_on_card_matches_cpu(cuda):
    """The ESL fast path on the card (one launch of kernel A, two of kernel
    B) equals the CPU port and the brute force."""
    from xmaps_tpu_torch.apps.eval_esl import build_device_depth_init, depth_init_dense
    from xmaps_tpu_torch.calib.maps import CamProjMaps

    calib = make_synthetic_calibration(camera_width=64, camera_height=48, projector_width=90,
                                       projector_height=160, rectification_scale=3.0)
    maps = CamProjMaps(calib, zero_undistort_proj_map=True)
    proj_rect = maps.build_rectified_time_map(scan_upwards=False, border_replicate=False)
    p03 = float(maps.P2[0, 3])
    rng = np.random.default_rng(7)
    cam = np.where(rng.random((48, 64)) < 0.8, rng.random((48, 64)), 0).astype(np.float32)
    fn = build_device_depth_init(maps, calib, proj_rect, p03, "cuda")
    _build.reset_launch_counts()
    disp, depth = fn(torch.from_numpy(cam).cuda())
    torch.cuda.synchronize()
    assert _build.LAUNCHES["esl_disparity_search"] == 1
    assert _build.LAUNCHES["remap_gather"] == 2
    cpu = build_device_depth_init(maps, calib, proj_rect, p03, "cpu")
    for a, b in zip((disp, depth), cpu(torch.from_numpy(cam))):
        _equal(a, b)
    odisp, odepth = depth_init_dense(cam, maps, proj_rect, p03, "cuda")
    assert np.array_equal(disp.cpu().numpy(), odisp) and disp.cpu().numpy().any()
    assert np.array_equal(depth.cpu().numpy(), odepth)


# -- kernel W and the pinned staging of the streaming pipe -------------------


def test_warmup_kernel_matches_plain_on_card(cuda):
    from xmaps_tpu_torch.ops.warmup import WARMUP_SHAPE, warmup_add_one, warmup_add_one_plain

    rng = np.random.default_rng(9)
    for shape in (WARMUP_SHAPE, (3, 1000)):
        x = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int32)).cuda()
        _build.reset_launch_counts()
        got = warmup_add_one(x)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["warmup_add_one"] == 1
        _equal(got, warmup_add_one_plain(x))
    with pytest.raises(ValueError, match="int32"):
        warmup_add_one(torch.zeros(WARMUP_SHAPE, device=cuda))


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "two_word"])
def test_pinned_staging_matches_pageable(cuda, compact):
    """40 frames staged into 2 pinned slots back to back while the stream
    is held busy, so every copy is still queued when the host comes round
    to its slot again: the CUDA event recorded after a slot's copy must
    hold the refill back.  Every batch equals pageable staging."""
    from xmaps_tpu_torch.io.prefetch import (
        CompactLayout,
        HostStagingPool,
        unpack_staged,
        unpack_staged_compact,
    )
    from xmaps_tpu_torch.io.evt_decoder import EVENT_DTYPE
    from xmaps_tpu_torch.config import PipelineConfig

    cap = 1 << 15
    layout = CompactLayout.for_pipeline(PipelineConfig(640, 480, 720, 1280, 1760, 1320))
    pinned = HostStagingPool(cap, depth=2, device=cuda, layout=layout)
    pageable = HostStagingPool(cap, depth=2, device="cpu", layout=layout)
    assert all(t.is_pinned() for s in pinned._slots for t in s.tensors.values())
    rng = np.random.default_rng(2)
    frames = []
    for i in range(40):
        n = int(rng.integers(1000, cap + 2000))
        ev = np.zeros(n, dtype=EVENT_DTYPE)
        ev["x"], ev["y"] = rng.integers(0, 640, n), rng.integers(0, 480, n)
        ev["p"] = rng.integers(0, 2, n)
        ev["t"] = 10**6 * i + np.sort(rng.integers(0, 16_000, n))
        frames.append(ev)
    torch.cuda._sleep(200_000_000)  # keep the stream busy (~0.1 s)
    stage = "stage_compact" if compact else "stage"
    got = [getattr(pinned, stage)(ev) for ev in frames]
    torch.cuda.synchronize()
    for g, ev in zip(got, frames):
        want = getattr(pageable, stage)(ev)
        if compact:
            (gb, gts), (wb, wts) = (unpack_staged_compact(b, layout) for b in (g, want))
            _equal(gts, wts.cuda())
        else:
            gb, wb = unpack_staged(g), unpack_staged(want)
        for a, b in zip(gb, wb):
            _equal(a, b.cuda())


# -- kernel 1 with a dedup filter's priority, kernel S ----------------------


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_event_scatter_priority_matches_plain_on_card(cuda, camera_perspective):
    """Kernel 1 with the scatter priority of each dedup filter (and a
    reversed-lane one) equals its plain version; one launch a call."""
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES
    from xmaps_tpu_torch.ops.frame_pipeline import filter_events

    eng = _engine(camera_perspective)
    cfg, plan = eng.cfg, eng.plan
    if camera_perspective:
        kw = dict(camera_view=True, window=(0, 0), out_shape=(cfg.camera_height, cfg.camera_width))
    else:
        kw = dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
                  out_shape=(plan.H, plan.W))
    for ev in _frames():
        batch = eng.make_batch(ev)
        cases = [(batch, torch.arange(batch.capacity - 1, -1, -1, dtype=torch.int32,
                                      device=cuda))]
        for name in FILTER_NAMES[1:]:
            cases.append(filter_events(batch, eng.tables, cfg.replace(frame_filter=name)))
        for fbatch, prio in cases:
            t_bin = scale_time(fbatch.t, fbatch.valid, cfg.t_px_scale)
            _build.reset_launch_counts()
            got = event_disparity_scatter(fbatch, t_bin, eng.tables, priority=prio, **kw)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["event_disparity_scatter"] == 1
            ref = event_disparity_scatter_plain(fbatch, t_bin, eng.tables, priority=prio, **kw)
            _equal(got.packed_map, ref.packed_map)
            _equal(got.num_inliers, ref.num_inliers)


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_filtered_engine_on_card_matches_cpu(cuda, camera_perspective):
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES

    eng = _engine(camera_perspective)
    cpu = eng.to("cpu")
    try:
        for name in FILTER_NAMES[1:]:
            eng.set_frame_filter(name)
            cpu.set_frame_filter(name)
            for ev in _frames():
                got, ref = eng.process_frame(ev), cpu.process_frame(ev)
                for field in ("frame_bgr", "depth", "disp_map", "num_inliers"):
                    _equal(getattr(got, field), getattr(ref, field))
    finally:
        eng.set_frame_filter("none")


def test_tile_store_kernel_matches_plain_on_card(cuda):
    """Kernel S at the benchmark's shape and at shapes with ragged bands
    (rows not a multiple of 8, columns over one band), with collisions and
    events outside the tile."""
    from xmaps_tpu_torch.apps.bench_store_loop import make_inputs
    from xmaps_tpu_torch.ops.store_loop import (
        BENCH_EVENTS,
        BENCH_SHAPE,
        tile_store_last,
        tile_store_last_plain,
    )

    for n, shape in ((BENCH_EVENTS, BENCH_SHAPE), (5000, (13, 3100)), (300, (3, 5)), (0, (8, 8))):
        rows, cols, vals = make_inputs(n, shape, seed=n, device=cuda)
        rows[::53] = -2
        cols[::61] = shape[1]
        _build.reset_launch_counts()
        got = tile_store_last(rows, cols, vals, shape)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["tile_store_last"] == 1
        _equal(got, tile_store_last_plain(rows, cols, vals, shape))
    with pytest.raises(ValueError, match="int32"):
        tile_store_last(rows.long(), cols, vals, shape)
