"""The CUDA kernels on the card vs their plain PyTorch versions (small rigs).

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
false.  On a machine with an NVIDIA GPU (sm_90a, nvcc on PATH or under
/usr/local/cuda) run them with

    python -m pytest tests/test_torch_cuda.py -m gpu -q

These tests import nothing of JAX; the CPU tests hold the plain versions
against the JAX package.
"""

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmaps_tpu_torch.io.prefetch import stage_compact_group  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine  # noqa: E402
from xmaps_tpu_torch.ops import _build  # noqa: E402
from xmaps_tpu_torch.ops.cuda_events import (  # noqa: E402
    EventScatterResult,
    event_disparity_scatter,
    event_disparity_scatter_group,
    event_disparity_scatter_group_plain,
    event_disparity_scatter_plain,
    event_disparity_scatter_staged_group,
    event_disparity_scatter_staged_group_plain,
)
from xmaps_tpu_torch.ops.cuda_tail import (  # noqa: E402
    colorize_camera,
    colorize_camera_group,
    colorize_camera_group_plain,
    colorize_camera_plain,
    tail_projector,
    tail_projector_group,
    tail_projector_group_plain,
    tail_projector_plain,
)
from xmaps_tpu_torch.ops.disparity import scale_time  # noqa: E402
from xmaps_tpu_torch.ops.esl_denoise import denoise_scalars  # noqa: E402
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
    # one program for the group: kernel 1's group entry once, the tail's once
    assert _build.LAUNCHES["event_disparity_scatter_group"] == 1
    assert _build.LAUNCHES[tail + "_group"] == 1
    assert _build.LAUNCHES["event_disparity_scatter"] == _build.LAUNCHES[tail] == 0
    for ev, got, ref in zip(frames, outs, cpu.process_frames(frames)):
        assert got.frame_bgr.device.type == "cuda"
        one = eng.process_frame(ev)
        for name in ("frame_bgr", "depth", "disp_map", "num_inliers"):
            _equal(getattr(got, name), getattr(ref, name))
            _equal(getattr(got, name), getattr(one, name))


def test_wrappers_check_inputs(cuda):
    eng = _engine(False)
    plan = eng.plan
    with pytest.raises(ValueError, match="packed_crop"):
        tail_projector(torch.zeros((plan.H + 1, plan.W), dtype=torch.int32, device=cuda),
                       eng.tables, plan)
    with pytest.raises(ValueError, match="packed_crop"):
        tail_projector(torch.zeros((plan.H, plan.W), dtype=torch.float32, device=cuda),
                       eng.tables, plan)


def _tail_rig(crop_shape, proj_shape, seed, frames=None):
    """A hand-made projector tail on the card: a crop at (5, 9) of a
    40 x 70 rect frame, projector maps drawn around the crop (some inside
    the frame but outside the crop, some outside the frame), the plan's
    colorize table built on the card, and random packed words with every
    priority bit random: (H, W), or (frames, H, W) where given."""
    from xmaps_tpu_torch.ops.cuda_tail import TailPlan, with_colorize_table
    from xmaps_tpu_torch.ops.frame_pipeline import DeviceTables

    rng = np.random.default_rng(seed)
    (H, W), (Hp, Wp) = crop_shape, proj_shape
    r0, c0 = 5, 9
    mapx = rng.integers(c0 - 3, c0 + W + 3, (Hp, Wp)).astype(np.int16)
    mapy = rng.integers(r0 - 3, r0 + H + 3, (Hp, Wp)).astype(np.int16)
    mapx[0, :3] = -1
    mapy[-1, -2:] = 40
    zero = np.zeros((1, 1), np.int16)
    tables = DeviceTables.from_numpy(zero, zero, zero, mapx, mapy, 40.0, "cuda")
    plan = with_colorize_table(TailPlan(full_H=40, full_W=70, crop_row0=r0, crop_col0=c0,
                                        H=H, W=W, p03=40.0, z_near=0.2, z_far=1.2), tables)
    shape = (H, W) if frames is None else (frames, H, W)
    words = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    return plan, tables, torch.from_numpy(words).cuda()


@pytest.mark.parametrize("crop_shape,proj_shape", [
    ((37, 70), (29, 31)),  # 899 projector pixels: a ragged tail of 3
    ((1, 45), (16, 24)),  # a crop of one row
    ((45, 1), (13, 7)),  # a crop of one column; 91 pixels
    ((16, 32), (8, 16)),  # exactly one dilate tile, no ragged tail
], ids=["ragged", "one_row", "one_col", "one_tile"])
def test_tail_projector_edges_on_card(cuda, crop_shape, proj_shape):
    """Kernel 2 (dilate + remap/colorize) against its plain version in all
    three output variants; one counted launch a call."""
    plan, tables, words = _tail_rig(crop_shape, proj_shape, seed=sum(crop_shape))
    for variant in VARIANTS:
        _build.reset_launch_counts()
        got = tail_projector(words, tables, plan, **variant)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["tail_projector"] == 1
        assert _build.LAUNCHES["colorize_table"] == 0
        want = tail_projector_plain(words, tables, plan, **variant)
        for a, b in zip(got, want):
            _equal(a, b)
        assert tuple(got[0].shape[:2]) == proj_shape


@pytest.mark.parametrize("frames", [1, 2, 12])
@pytest.mark.parametrize("crop_shape,proj_shape", [
    ((37, 70), (29, 31)),  # 899 projector pixels: ragged for 4 and 8 px a thread
    ((7, 11), (9, 13)),  # a crop smaller than one dilate tile; 117 pixels
    ((45, 1), (13, 7)),  # a crop of one column; 91 pixels
    ((70, 200), (16, 24)),  # several dilate tiles each way, no ragged tail
], ids=["ragged", "tiny_crop", "one_col", "tiles"])
def test_tail_projector_group_edges_on_card(cuda, crop_shape, proj_shape, frames):
    """Kernel 2's group entry (the projector maps read once for the F
    frames, each frame's outputs at a multiple of 8 pixels, each frame's
    ragged tail scalar) against its plain version in all three output
    variants, over outputs allocated on memory filled with garbage; one
    counted launch a call, no table built."""
    plan, tables, words = _tail_rig(crop_shape, proj_shape, seed=sum(crop_shape) + frames,
                                    frames=frames)
    for variant in VARIANTS:
        garbage = [torch.full((4 * 11 * frames * proj_shape[0] * proj_shape[1],), 0x7B,
                              dtype=torch.uint8, device=cuda) for _ in range(3)]
        del garbage
        _build.reset_launch_counts()
        got = tail_projector_group(words, tables, plan, **variant)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["tail_projector_group"] == 1
        assert _build.LAUNCHES["colorize_table"] == _build.LAUNCHES["tail_projector"] == 0
        want = tail_projector_group_plain(words, tables, plan, **variant)
        for a, b in zip(got, want):
            _equal(a, b)
        assert tuple(got[0].shape[:3]) == (frames, *proj_shape)
        for f in (0, frames - 1):
            for a, b in zip(got, tail_projector(words[f], tables, plan, **variant)):
                _equal(None if a is None else a[f], b)


def test_tail_projector_refuses_missing_or_foreign_table(cuda):
    """Both entries of kernel 2 raise, and launch nothing, where the plan
    holds no colorize table or holds it on another device."""
    import dataclasses

    plan, tables, words = _tail_rig((8, 8), (4, 6), seed=2)
    bare = dataclasses.replace(plan, table=None)
    on_cpu = dataclasses.replace(plan, table=tuple(t.cpu() for t in plan.table))
    _build.reset_launch_counts()
    for bad in (bare, on_cpu):
        with pytest.raises(ValueError, match="no colorize table"):
            tail_projector(words, tables, bad)
        with pytest.raises(ValueError, match="no colorize table"):
            tail_projector_group(words[None], tables, bad)
    assert _build.LAUNCHES["tail_projector"] == _build.LAUNCHES["tail_projector_group"] == 0


def test_tail_projector_refuses_misaligned_maps(cuda):
    plan, tables, words = _tail_rig((8, 8), (4, 6), seed=1)
    buf = torch.zeros(4 * 6 + 1, dtype=torch.int16, device=cuda)
    view = buf[1:].view(4, 6)  # contiguous, 2 bytes past an aligned start
    assert view.is_contiguous() and view.data_ptr() % 16
    for field in ("proj_mapx_i16", "proj_mapy_i16"):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tail_projector(words, tables._replace(**{field: view}), plan)


# -- kernel 3 and its colorize table ------------------------------------------


def _cam_rig(shape, seed):
    """A camera-view plan of ``shape`` with its colorize table on the card
    (the demonstrator's scalars), and random packed words with every
    priority bit random."""
    from xmaps_tpu_torch.ops.cuda_tail import CamTailPlan, with_colorize_table
    from xmaps_tpu_torch.ops.frame_pipeline import DeviceTables

    zero = np.zeros((1, 1), np.int16)
    tables = DeviceTables.from_numpy(zero, zero, zero, zero, zero, 187.25, "cuda")
    plan = with_colorize_table(
        CamTailPlan(H=shape[0], W=shape[1], p03=187.25, z_near=0.2, z_far=1.2), tables)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    return plan, tables, torch.from_numpy(words).cuda()


def test_colorize_table_matches_plain_on_card(cuda):
    """The table built on the card holds the plain epilogue of every
    disparity 0 .. PACK - 1: the BGR words and the depth bits."""
    from xmaps_tpu_torch.ops.cuda_tail import build_colorize_table, colorize_table_plain
    from xmaps_tpu_torch.ops.scatter import PACK

    plan, tables, _ = _cam_rig((1, 1), seed=0)
    _build.reset_launch_counts()
    bgr, depth = build_colorize_table(tables, plan)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["colorize_table"] == 1
    ref_bgr, ref_depth = colorize_table_plain(tables, plan)
    assert bgr.shape == depth.shape == (PACK,)
    _equal(bgr, ref_bgr)
    _equal(depth.view(torch.int32), ref_depth.view(torch.int32))
    _equal(plan.table[0], ref_bgr)
    _equal(plan.table[1].view(torch.int32), ref_depth.view(torch.int32))
    assert len(torch.unique(bgr)) > 100


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (1, 8), (1, 9), (31, 223), (480, 640)],
                         ids=["n1", "n7", "n8", "n9", "n6913", "n307200"])
def test_colorize_camera_edges_on_card(cuda, shape):
    """Kernel 3 (4 pixels a thread, the last thread a ragged tail) against
    its plain version in all three output variants, its outputs allocated
    over memory filled with garbage; one counted launch a call."""
    plan, tables, words = _cam_rig(shape, seed=shape[0] * shape[1])
    for variant in VARIANTS:
        # three blocks of garbage return to the cache the outputs come from
        garbage = [torch.full((4 * shape[0] * shape[1],), 0x7B, dtype=torch.uint8,
                              device=cuda) for _ in range(3)]
        del garbage
        _build.reset_launch_counts()
        got = colorize_camera(words, tables, plan, **variant)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["colorize_camera"] == 1
        assert _build.LAUNCHES["colorize_table"] == 0
        want = colorize_camera_plain(words, tables, plan, **variant)
        for a, b in zip(got, want):
            _equal(a, b)
        assert tuple(got[0].shape[:2]) == shape


def test_colorize_camera_refuses_misaligned_map_and_no_table(cuda):
    import dataclasses

    plan, tables, words = _cam_rig((4, 6), seed=1)
    buf = torch.zeros(4 * 6 + 1, dtype=torch.int32, device=cuda)
    view = buf[1:].view(4, 6)  # contiguous, 4 bytes past an aligned start
    assert view.is_contiguous() and view.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        colorize_camera(view, tables, plan)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="no colorize table"):
        colorize_camera(words, tables, dataclasses.replace(plan, table=None))
    with pytest.raises(ValueError, match="no colorize table"):
        colorize_camera(words, tables, dataclasses.replace(
            plan, table=tuple(t.cpu() for t in plan.table)))
    assert _build.LAUNCHES["colorize_table"] == _build.LAUNCHES["colorize_camera"] == 0


def test_engine_to_rebuilds_colorize_table(cuda):
    """A camera-view engine holds its table on the card; moved to the CPU it
    holds none (the plain version runs), moved back it builds it again."""
    eng = _engine(True)
    assert eng.plan.table is not None and eng.plan.table[0].device.type == "cuda"
    cpu = eng.to("cpu")
    assert cpu.plan.table is None
    _build.reset_launch_counts()
    back = cpu.to("cuda")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["colorize_table"] == 1
    assert back.plan.table[0].device.type == "cuda"
    _equal(back.plan.table[0], eng.plan.table[0])
    _equal(back.plan.table[1].view(torch.int32), eng.plan.table[1].view(torch.int32))
    assert eng.to("cuda").plan.table is eng.plan.table  # kept on its own device
    frames = _frames()
    for got, ref in zip(back.process_frames(frames), cpu.process_frames(frames)):
        for name in ("frame_bgr", "depth", "disp_map", "num_inliers"):
            _equal(getattr(got, name), getattr(ref, name))


def test_engine_to_rebuilds_projector_table(cuda):
    """A projector-view engine holds its colorize table on the card (built
    with the engine, from the plan's p03, equal to the tables' p03); moved
    to the CPU it holds none, moved back it builds it again (one launch);
    ``replicate`` onto the card, as a virtual mesh's replicas are made,
    builds it from a CPU plan and keeps it where it lies."""
    from xmaps_tpu_torch.ops.cuda_tail import colorize_table_plain
    from xmaps_tpu_torch.parallel import make_mesh, make_sharded_pipeline, shard_batches
    from xmaps_tpu_torch.parallel.sharding import replicate

    eng = _engine(False)
    # the table's p03 goes to the card as float32: the plain chain's float32
    assert torch.equal(torch.tensor(eng.plan.p03, dtype=torch.float32), eng.tables.p03.cpu())
    bgr, depth = eng.plan.table
    assert bgr.device.type == "cuda"
    ref_bgr, ref_depth = colorize_table_plain(eng.tables, eng.plan)
    _equal(bgr, ref_bgr)
    _equal(depth.view(torch.int32), ref_depth.view(torch.int32))
    cpu = eng.to("cpu")
    assert cpu.plan.table is None
    _build.reset_launch_counts()
    back = cpu.to("cuda")
    _, plan = replicate(cpu.tables, cpu.plan, "cuda")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["colorize_table"] == 2
    for p in (back.plan, plan):
        _equal(p.table[0], bgr)
        _equal(p.table[1].view(torch.int32), depth.view(torch.int32))
    assert eng.to("cuda").plan.table is eng.plan.table  # kept on its own device
    assert replicate(eng.tables, eng.plan, "cuda")[1].table is eng.plan.table
    mesh = make_mesh(["cuda:0"] * 2, data=2)
    frames = _frames()
    _build.reset_launch_counts()
    out = make_sharded_pipeline(eng.cfg, eng.tables, mesh, eng.plan)(
        shard_batches([eng.make_batch(ev) for ev in frames], mesh, eng.cfg))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["colorize_table"] == 0
    assert _build.LAUNCHES["tail_projector_group"] == 2
    for i, (ev, ref) in enumerate(zip(frames, cpu.process_frames(frames))):
        for a, b in zip(out, ref):
            _equal(a[i], b)
    for got, ref in zip(back.process_frames(frames), cpu.process_frames(frames)):
        for a, b in zip(got, ref):
            _equal(a, b)


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
    prep_kw = dict(max_disp=200, row_range=(11, 37), col_range=(70, 300))
    kw = dict(prep_kw, min_disp=5)
    want = esl_disparity_search(torch.from_numpy(cam), torch.from_numpy(proj), **kw)
    prep = esl_search_prep(torch.from_numpy(proj).cuda(), **prep_kw)
    _build.reset_launch_counts()
    got = esl_disparity_search(torch.from_numpy(cam).cuda(), None, prep=prep, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["esl_disparity_search"] == 1
    _equal(got, want)
    assert want.any()


@pytest.mark.parametrize("with_inb", [False, True])
def test_remap_gather_matches_plain_on_card(cuda, with_inb):
    from xmaps_tpu_torch.ops.remap import build_remap_indices, pack_remap_index, remap_gather

    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.random((48, 64)).astype(np.float32))
    map_x = (rng.random((120, 200)) * 64 * 1.2 - 4).astype(np.float32)
    map_y = (rng.random((120, 200)) * 48 * 1.2 - 4).astype(np.float32)
    yi, xi, inb = build_remap_indices(map_x, map_y, (48, 64))
    idx = torch.from_numpy(pack_remap_index(yi, xi, inb if with_inb else None, (48, 64)))
    want = remap_gather(src, idx)
    _build.reset_launch_counts()
    got = remap_gather(src.cuda(), idx.cuda())
    torch.cuda.synchronize()
    assert _build.LAUNCHES["remap_gather"] == 1
    _equal(got, want)


@pytest.mark.parametrize("case", ["ragged", "one_row", "one_col", "all_invalid", "wild"])
def test_remap_gather_edges_on_card(cuda, case):
    """Kernel B against its plain version at ragged lengths (n % 4 != 0,
    the scalar tail), a one-row and a one-column destination, all indices
    -1, and indices outside the source on both sides."""
    from xmaps_tpu_torch.ops.remap import remap_gather, remap_gather_plain

    rng = np.random.default_rng(len(case))
    src = torch.from_numpy(rng.random((37, 53)).astype(np.float32)).cuda()
    n_src = src.numel()
    shape = {"ragged": (7, 13), "one_row": (1, 203), "one_col": (203, 1),
             "all_invalid": (9, 11), "wild": (31, 33)}[case]
    assert (shape[0] * shape[1]) % 4 != 0
    if case == "all_invalid":
        idx = np.full(shape, -1)
    elif case == "wild":
        idx = rng.integers(-3 * n_src, 3 * n_src, shape)
    else:
        idx = rng.integers(-1, n_src, shape)
    idx = torch.from_numpy(idx.astype(np.int32)).cuda()
    got = remap_gather(src, idx)
    torch.cuda.synchronize()
    _equal(got, remap_gather_plain(src, idx))
    assert got.any() != (case == "all_invalid")


def test_remap_gather_refuses_misaligned_index(cuda):
    from xmaps_tpu_torch.ops.remap import remap_gather

    src = torch.zeros((8, 8), device=cuda)
    buf = torch.zeros(4 * 4 + 1, dtype=torch.int32, device=cuda)
    idx = buf[1:].view(4, 4)  # contiguous, 4 bytes past an aligned start
    assert idx.is_contiguous() and idx.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        remap_gather(src, idx)


def test_device_depth_init_on_card_matches_cpu(cuda):
    """The ESL fast path on the card (one launch of kernel A, two of kernel
    B) equals the CPU port and the brute force."""
    from xmaps_tpu_torch.calib.maps import CamProjMaps
    from xmaps_tpu_torch.models.esl_pipeline import build_device_depth_init, depth_init_dense

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
    from xmaps_tpu_torch.io.prefetch import HostStagingPool
    from xmaps_tpu_torch.ops.staged import (
        CompactLayout,
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


@pytest.mark.parametrize("case", ["empty", "one_cell", "bench", "ragged", "tall", "one_row",
                                  "several_clusters", "column_chunks"])
def test_tile_store_cluster_edges_on_card(cuda, case):
    """Kernel S's 16-block clusters against the plain version: no event,
    every event into one cell, the benchmark's tile, ragged bands (rows not
    a multiple of 16), a tile of fewer rows than the cluster has blocks, a
    4 MiB tile that several clusters share, and rows wider than one block's
    shared memory (column chunks); events outside the tile on both sides.
    The output memory held garbage before the call."""
    from xmaps_tpu_torch.apps.bench_store_loop import make_inputs
    from xmaps_tpu_torch.ops.store_loop import BENCH_EVENTS, tile_store_last, tile_store_last_plain

    n, shape = {"empty": (0, (64, 1152)), "one_cell": (BENCH_EVENTS, (64, 1152)),
                "bench": (BENCH_EVENTS, (64, 1152)), "ragged": (9000, (67, 1151)),
                "tall": (4000, (5, 333)), "one_row": (700, (1, 4097)),
                "several_clusters": (200_000, (1024, 1024)),
                "column_chunks": (30_000, (3, 70_001))}[case]
    rows, cols, vals = make_inputs(n, shape, seed=len(case), device=cuda)
    if case == "one_cell":
        rows.fill_(5)
        cols.fill_(7)
    elif n:
        rows[::53], rows[1::97] = -2, shape[0]
        cols[::61], cols[2::89] = shape[1], -1
    junk = torch.full(shape, -1, dtype=torch.int32, device=cuda)
    del junk
    _build.reset_launch_counts()
    got = tile_store_last(rows, cols, vals, shape)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["tile_store_last"] == 1
    want = tile_store_last_plain(rows, cols, vals, shape)
    _equal(got, want)
    if case == "one_cell":
        assert int(want[5, 7]) == int(vals[-1]) and int((want != 0).sum()) == 1


# -- kernel 1: zeroing inside the launch, the staged entry, the filter repair --


def _scatter_rig(capacity, n, seed):
    """The small engine's tables and ``n`` random events (a tenth outside
    the 128 x 96 camera) in a batch of ``capacity`` lanes on the card."""
    eng = _engine(True)
    rng = np.random.default_rng(seed)
    x, y = rng.integers(-4, 134, n), rng.integers(-4, 100, n)
    t = rng.random(n).astype(np.float32)
    batch = EventBatch.from_arrays(x, y, t, np.ones(n), capacity, device="cuda")
    return eng, batch, scale_time(batch.t, batch.valid, eng.cfg.t_px_scale)


@pytest.mark.parametrize("capacity", [1, 255, 28672, 307200])
def test_event_scatter_zeroing_on_card(cuda, capacity):
    """Kernel 1, which zeroes its map inside its cooperative launch, at
    capacities from one lane to the eval's, into ragged maps (a word count that is no multiple of 4),
    a 1 x 1 map and the camera frame, in both views, into memory that held
    garbage; one launch a call, the map and count equal to the plain
    version's."""
    n = {1: 1, 255: 200, 28672: 28000, 307200: 300000}[capacity]
    eng, batch, t_bin = _scatter_rig(capacity, n, seed=capacity)
    for camera_view in (True, False):
        for window, out_shape in (((10, 20), (37, 53)), ((50, 60), (1, 1)), ((0, 0), (96, 128))):
            kw = dict(camera_view=camera_view, window=window, out_shape=out_shape)
            junk = torch.full((out_shape[0] * out_shape[1] + 64,), -1, dtype=torch.int32,
                              device=cuda)
            del junk
            _build.reset_launch_counts()
            got = event_disparity_scatter(batch, t_bin, eng.tables, **kw)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["event_disparity_scatter"] == 1
            ref = event_disparity_scatter_plain(batch, t_bin, eng.tables, **kw)
            _equal(got.packed_map, ref.packed_map)
            _equal(got.num_inliers, ref.num_inliers)


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_event_scatter_staged_on_card(cuda, camera_perspective):
    """Kernel 1's staged entry against its plain version (the 1-word unpack
    and the plain scatter, on the same card tensors): the engine's frames
    staged as the pipe stages them, at count 0, below the capacity and at
    the capacity, and random words filling 32 bits (bit 31 set) at a
    layout of 7 + 7 + 18 bits; one launch a call."""
    from xmaps_tpu_torch.io.prefetch import HostStagingPool
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter_staged,
        event_disparity_scatter_staged_plain,
    )
    from xmaps_tpu_torch.ops.staged import CompactLayout

    eng = _engine(camera_perspective)
    cfg, plan = eng.cfg, eng.plan
    if camera_perspective:
        kw = dict(camera_view=True, window=(0, 0), out_shape=(cfg.camera_height, cfg.camera_width))
    else:
        kw = dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
                  out_shape=(plan.H, plan.W))
    frames = _frames()
    cases = []
    for cap in (cfg.event_capacity, 512):
        pool = HostStagingPool(cap, device=cuda, layout=eng.compact_layout)
        for ev in frames + [frames[0][:0]]:
            staged = pool.stage_compact(ev)
            cases.append((staged.word, staged.count, eng.compact_layout))
    assert {c[1] for c in cases} >= {0, 512}
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    wide = CompactLayout(7, 7, 18, cfg.t_px_scale)
    words[::2] &= np.uint32(0x3FFF | (cfg.t_px_scale << 14))  # bins inside the X-map
    cases.append((torch.from_numpy(words.view(np.int32)).cuda(), 3000, wide))
    for word, count, layout in cases:
        _build.reset_launch_counts()
        got = event_disparity_scatter_staged(word, count, layout, eng.tables, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["event_disparity_scatter"] == 1
        ref = event_disparity_scatter_staged_plain(word, count, layout, eng.tables, **kw)
        _equal(got.packed_map, ref.packed_map)
        _equal(got.num_inliers, ref.num_inliers)
    with pytest.raises(ValueError, match="count"):
        event_disparity_scatter_staged(word, word.shape[0] + 1, layout, eng.tables, **kw)


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_filters_out_of_camera_on_card(cuda, camera_perspective):
    """Each dedup filter on frames with events outside the camera (past the
    last column on the last row, rows past the last one): no device-side
    assert, and every frame equal to the CPU run."""
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES
    from xmaps_tpu_torch.utils.synthetic import with_events_outside_camera

    eng = _engine(camera_perspective)
    cpu = eng.to("cpu")
    cam_w, cam_h = eng.cfg.camera_width, eng.cfg.camera_height
    rng = np.random.default_rng(8)
    frames = [with_events_outside_camera(ev, rng, cam_w, cam_h, n=100) for ev in _frames()]
    try:
        for name in FILTER_NAMES[1:]:
            eng.set_frame_filter(name)
            cpu.set_frame_filter(name)
            for ev in frames:
                got, ref = eng.process_frame(ev), cpu.process_frame(ev)
                torch.cuda.synchronize()
                for field in ("frame_bgr", "depth", "disp_map", "num_inliers"):
                    _equal(getattr(got, field), getattr(ref, field))
    finally:
        eng.set_frame_filter("none")


# -- the packet ring and kernel 1's ring entry --------------------------------

def _ring_packets(ev, k, rng, layout, device, span_us):
    """``ev`` as k arrival packets of ``span_us`` each
    (``utils.synthetic.as_arrival_packets``), staged into a ring on
    ``device``; the frame starts inside the first packet and ends inside
    the last.  Returns (ring, frame, packets, meta)."""
    from xmaps_tpu_torch.io.prefetch import PacketRing
    from xmaps_tpu_torch.utils.synthetic import as_arrival_packets

    ev, packets = as_arrival_packets(ev, k, span_us, rng)
    ring = PacketRing(packet_capacity=len(ev), n_slots=16, device=device, layout=layout)
    for packet in packets:
        assert ring.stage_packets(packet)
    gs, ge = int(rng.integers(1, 50)), len(ev) - int(rng.integers(1, 50))
    pkts, meta = ring.frame_meta(gs, ge, int(ev["t"][gs]))
    assert len(pkts) == k and meta[0, 0] > 0
    return ring, ev[gs:ge], pkts, meta


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_ring_entry_on_card(cuda, camera_perspective):
    """Kernel 1's ring entry against its plain version (the compact ring
    assembly, ``scale_time`` and the plain scatter, on the same card rows)
    at k = 1, 4 and 8 packets with partial first and last packets, under,
    at a ragged count of and over the capacity, words with bit 31 set (the
    small rig's 7 + 7 + 18-bit layout, 200 ms packets), into memory that
    held garbage; one launch a call."""
    from xmaps_tpu_torch.io.prefetch import ring_time_bounds
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter_ring,
        event_disparity_scatter_ring_plain,
    )

    eng = _engine(camera_perspective)
    cfg, plan = eng.cfg, eng.plan
    if camera_perspective:
        kw = dict(camera_view=True, window=(0, 0), out_shape=(cfg.camera_height, cfg.camera_width))
    else:
        kw = dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
                  out_shape=(plan.H, plan.W))
    layout = eng.ring_layout
    assert layout == (7, 7, 18)
    frames = _frames()
    events = np.concatenate(frames)
    rng = np.random.default_rng(6)
    for k in (1, 4, 8):
        for span in (4000, 200_000):
            ring, frame, pkts, meta = _ring_packets(events, k, rng, layout, cuda, span)
            rows = tuple(p.xy for p in pkts)
            if span > 2**17:
                assert (ring.rows["xy"].cpu().numpy().view(np.uint32) >> 31).any()
            for cap in (cfg.event_capacity, 1777, len(frame)):
                count = min(len(frame), cap)
                t_bounds = ring_time_bounds(frame, cap)
                args = (rows, meta, count, t_bounds, layout, eng.tables)
                junk = torch.full((kw["out_shape"][0] * kw["out_shape"][1] + 64,), -1,
                                  dtype=torch.int32, device=cuda)
                del junk
                _build.reset_launch_counts()
                got = event_disparity_scatter_ring(*args, t_px_scale=cfg.t_px_scale, **kw)
                torch.cuda.synchronize()
                assert _build.LAUNCHES["event_disparity_scatter"] == 1
                ref = event_disparity_scatter_ring_plain(*args, t_px_scale=cfg.t_px_scale, **kw)
                _equal(got.packed_map, ref.packed_map)
                _equal(got.num_inliers, ref.num_inliers)
                assert int(got.num_inliers) > 100
    assert len(events) > cfg.event_capacity  # the last case runs over the capacity


def test_ring_entry_refusals(cuda):
    """The ring entry raises ValueError on 0 or 9 packets and on rows or
    tables on another device than the rows."""
    from xmaps_tpu_torch.io.prefetch import ring_time_bounds
    from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter_ring

    eng = _engine(True)
    kw = dict(t_px_scale=eng.cfg.t_px_scale, camera_view=True, window=(0, 0), out_shape=(96, 128))
    events = np.concatenate(_frames())
    ring, frame, pkts, meta = _ring_packets(events, 8, np.random.default_rng(1), eng.ring_layout,
                                            cuda, 4000)
    rows = tuple(p.xy for p in pkts)
    tb = ring_time_bounds(frame, 4096)
    with pytest.raises(ValueError, match="packets"):
        event_disparity_scatter_ring((), np.zeros((3, 0), np.int32), 1, tb, eng.ring_layout,
                                     eng.tables, **kw)
    nine = np.concatenate([meta, meta[:, :1]], axis=1)
    with pytest.raises(ValueError, match="packets"):
        event_disparity_scatter_ring(rows + rows[:1], nine, 100, tb, eng.ring_layout,
                                     eng.tables, **kw)
    with pytest.raises(ValueError, match="packet row"):
        event_disparity_scatter_ring(rows[:7] + (rows[7].cpu(),), meta, 100, tb,
                                     eng.ring_layout, eng.tables, **kw)
    with pytest.raises(ValueError, match="cam_map_packed"):
        event_disparity_scatter_ring(rows, meta, 100, tb, eng.ring_layout,
                                     eng.tables.to("cpu"), **kw)


def test_ring_host_row_guard(cuda):
    """A pinned host row is refilled right after its copy was queued behind
    a busy stream (its slot retired and taken again): the copy must still
    ship the old words, because the ring waits on the CUDA event recorded
    after the copy before it rewrites the row.  A snapshot of each device
    row, queued on the stream right after its copy, must hold the words
    that were staged."""
    from xmaps_tpu_torch.io.evt_decoder import EVENT_DTYPE
    from xmaps_tpu_torch.io.prefetch import PacketRing
    from xmaps_tpu_torch.ops.staged import RingLayout

    layout = RingLayout.for_camera(640, 480)
    ring = PacketRing(packet_capacity=4096, n_slots=16, device=cuda, layout=layout)
    assert ring._host["xy"].is_pinned()
    rng = np.random.default_rng(3)
    sent, snaps = [], []
    torch.cuda._sleep(200_000_000)  # keep the stream busy (~0.1 s)
    for _ in range(3):
        for _ in range(16):
            n = int(rng.integers(1000, 4096))
            ev = np.zeros(n, dtype=EVENT_DTYPE)
            ev["x"], ev["y"], ev["p"] = rng.integers(0, 640, n), rng.integers(0, 480, n), 1
            ev["t"] = 10**6 + np.sort(rng.integers(0, 8000, n))
            assert ring.stage_packets(ev)
            slot = ring._live[-1].slot
            sent.append(ring._xy[slot][:n].copy())
            snaps.append(ring.rows["xy"][slot].clone())
        ring.retire_below(10**9)
    torch.cuda.synchronize()
    for words, snap in zip(sent, snaps):
        np.testing.assert_array_equal(snap.cpu().numpy().view(np.uint32)[:len(words)], words)


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_process_ring_on_card_matches_cpu(cuda, camera_perspective):
    """``process_ring`` on the card (kernel 1's ring entry, with the host
    time bounds; and the torch assembly without them) against the CPU
    engine's on the same packets; one kernel 1 launch a frame."""
    from xmaps_tpu_torch.io.prefetch import ring_time_bounds

    eng = _engine(camera_perspective)
    cpu = eng.to("cpu")
    for seed, ev in enumerate(_frames()):
        rings = {dev: _ring_packets(ev, 4, np.random.default_rng(seed), eng.ring_layout, dev,
                                    4000) for dev in (cuda, "cpu")}
        ref = cpu.process_ring(*rings["cpu"][2:])
        _, frame, pkts, meta = rings[cuda]
        for tb in (ring_time_bounds(frame, eng.cfg.event_capacity), None):
            _build.reset_launch_counts()
            got = eng.process_ring(pkts, meta, tb)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["event_disparity_scatter"] == 1
            _equal(got.frame_bgr, ref.frame_bgr)
            _equal(got.num_inliers, ref.num_inliers)


# -- the group entries (process_frames as one program) -----------------------

#: a camera of 50 x 37 (1850 px, not a multiple of 4) and a projector of
#: 45 x 79 (3555 px, not a multiple of 8): ragged tails in every frame
ODD_SIZES = dict(camera_width=50, camera_height=37, projector_width=45, projector_height=79)


@functools.lru_cache(maxsize=None)
def _group_rig(camera_perspective, odd):
    """(engine, frames): capacity 1000 (not a multiple of 32: kernel 1's
    warps straddle frames) at the odd rig, else the engine of ``_engine``;
    seven frames, one empty and one over the capacity."""
    sizes = ODD_SIZES if odd else SIZES
    calib = make_synthetic_calibration(**sizes)
    eng = (XMapsDepthEngine.from_calibration(
        calib, device="cuda", event_capacity=1000, z_near=0.2, z_far=1.2,
        camera_perspective=camera_perspective) if odd else _engine(camera_perspective))
    cap = eng.cfg.event_capacity
    rng = np.random.default_rng(13)
    frames = []
    for i, frac in enumerate((0.3, 0.9, 0.0, 1.4, 0.6, 0.05, 1.0)):
        ev = simulate_plane_events(calib, depth_m=0.4 + 0.05 * i, subsample=0.5,
                                   jitter_us=2.0, rng=rng)
        frames.append(ev[:int(frac * cap)])
    return eng, frames


def _group_view(eng):
    cfg, plan = eng.cfg, eng.plan
    if cfg.camera_perspective:
        return (dict(camera_view=True, window=(0, 0),
                     out_shape=(cfg.camera_height, cfg.camera_width)),
                colorize_camera_group, colorize_camera_group_plain)
    return (dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
                 out_shape=(plan.H, plan.W)),
            tail_projector_group, tail_projector_group_plain)


@pytest.mark.parametrize("n_frames", [1, 7])
@pytest.mark.parametrize("odd", [False, True], ids=["aligned", "odd"])
@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_group_entries_match_plain_on_card(cuda, camera_perspective, odd, n_frames):
    """Kernel 1's array and staged group entries (with and without a
    priority) and the tail's group entry against their plain versions on
    the card, exactly, one launch each; at the odd rig with capacity 1000
    too."""
    eng, frames = _group_rig(camera_perspective, odd)
    frames = frames[:n_frames] if n_frames == 1 else frames
    kw, tail, tail_plain = _group_view(eng)
    cap, tables = eng.cfg.event_capacity, eng.tables
    batch = EventBatch.stack_structured(frames, cap, device=cuda)
    t_bin = scale_time(batch.t, batch.valid, eng.cfg.t_px_scale)
    prio = torch.from_numpy(np.random.default_rng(4).integers(
        0, cap, (len(frames), cap), dtype=np.int32)).to(cuda)
    staged = stage_compact_group(frames, cap, eng.compact_layout, device=cuda)
    _build.reset_launch_counts()
    for p in (None, prio):
        got = event_disparity_scatter_group(batch, t_bin, tables, priority=p, **kw)
        ref = event_disparity_scatter_group_plain(batch, t_bin, tables, priority=p, **kw)
        _equal(got.packed_map, ref.packed_map)
        _equal(got.num_inliers, ref.num_inliers)
    got = event_disparity_scatter_staged_group(staged, eng.compact_layout, tables, **kw)
    ref = event_disparity_scatter_staged_group_plain(staged, eng.compact_layout, tables, **kw)
    _equal(got.packed_map, ref.packed_map)
    _equal(got.num_inliers, ref.num_inliers)
    for variant in VARIANTS:
        for a, b in zip(tail(got.packed_map, tables, eng.plan, **variant),
                        tail_plain(got.packed_map, tables, eng.plan, **variant)):
            _equal(a, b)
    torch.cuda.synchronize()
    tail_name = "colorize_camera_group" if camera_perspective else "tail_projector_group"
    assert _build.LAUNCHES["event_disparity_scatter_group"] == 3
    assert _build.LAUNCHES[tail_name] == len(VARIANTS)
    assert _build.LAUNCHES["event_disparity_scatter"] == 0


def _edge_frames(n_frames, cap, seed, outside=True):
    """``n_frames`` frames of random events with integer times at the
    small rig: frame 0 half full or more, frame 1 over the capacity, frame
    2 empty, frame 3 (``outside``) every event past the camera's last
    column, the rest of random sizes up to the capacity."""
    rng = np.random.default_rng(seed)
    cam_w, cam_h = SIZES["camera_width"], SIZES["camera_height"]
    frames = []
    for f in range(n_frames):
        n = {0: int(rng.integers(cap // 2, cap + 1)), 1: cap + 500, 2: 0}.get(
            f, int(rng.integers(0, cap + 1)))
        ev = np.zeros(n, dtype=[("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<i8")])
        ev["x"] = rng.integers(cam_w, cam_w + 6, n) if f == 3 and outside else rng.integers(
            0, cam_w, n)
        ev["y"] = rng.integers(0, cam_h, n)
        ev["t"] = np.sort(rng.integers(0, 16000, n))
        ev["p"] = rng.integers(0, 2, n)
        frames.append(ev)
    return frames


def _poisoned(fn, words):
    """``fn()`` with the allocator's next block of ``words`` int32 freed
    holding -1, so outputs the kernel fails to write show."""
    junk = torch.full((words + 64,), -1, dtype=torch.int32, device="cuda")
    del junk
    return fn()


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
@pytest.mark.parametrize("capacity", [1000, 4099, 28672])
@pytest.mark.parametrize("n_frames", [1, 2, 12, 40])
def test_kernel1_group_edges_on_card(cuda, n_frames, capacity, camera_perspective):
    """Kernel 1's array and staged group entries against their plain
    versions, every map word and count exact, one launch a call: F = 1, 2,
    12 and 40 (40 x 28672 lanes are far more than the co-resident grid's
    threads: each thread walks lanes past the ones it gathers up front),
    capacities 1000 and 4099 (no multiple of 32: warps and blocks straddle
    frames) and 28672; a frame with no event, one over the capacity, one
    whose events all lie past the camera (the array group's), a priority,
    an ``index_offset``, and a window that leaves every lane outside the
    map."""
    eng = _engine(camera_perspective)
    kw, _, _ = _group_view(eng)
    tables, layout = eng.tables, eng.compact_layout
    frames = _edge_frames(n_frames, capacity, seed=n_frames * capacity)
    batch = EventBatch.stack_structured(frames, capacity, device=cuda)
    t_bin = scale_time(batch.t, batch.valid, eng.cfg.t_px_scale)
    prio = torch.from_numpy(np.random.default_rng(capacity).integers(
        0, capacity, (n_frames, capacity), dtype=np.int32)).to(cuda)
    staged = stage_compact_group(_edge_frames(n_frames, capacity, seed=capacity, outside=False),
                                 capacity, layout, device=cuda)
    far = dict(kw, window=(100000, 100000), out_shape=(7, 9))
    calls = [
        (dict(), kw), (dict(index_offset=777), kw), (dict(priority=prio), kw), (dict(), far),
    ]
    for extra, view in calls:
        words = n_frames * view["out_shape"][0] * view["out_shape"][1]
        _build.reset_launch_counts()
        got = _poisoned(lambda: event_disparity_scatter_group(
            batch, t_bin, tables, **extra, **view), words)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["event_disparity_scatter_group"] == 1
        ref = event_disparity_scatter_group_plain(batch, t_bin, tables, **extra, **view)
        _equal(got.packed_map, ref.packed_map)
        _equal(got.num_inliers, ref.num_inliers)
        if view is far:
            assert not bool(got.packed_map.any()) and int(got.num_inliers.sum()) > 0
    for view in (kw, far):
        words = n_frames * view["out_shape"][0] * view["out_shape"][1]
        _build.reset_launch_counts()
        got = _poisoned(lambda: event_disparity_scatter_staged_group(
            staged, layout, tables, **view), words)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["event_disparity_scatter_group"] == 1
        ref = event_disparity_scatter_staged_group_plain(staged, layout, tables, **view)
        _equal(got.packed_map, ref.packed_map)
        _equal(got.num_inliers, ref.num_inliers)


def test_kernel1_calls_stay_exact_back_to_back_on_card(cuda):
    """Nothing of one kernel 1 call leaks into the next (each zeroes its
    maps and counts and sums its inliers inside its own launch):
    back-to-back calls on one engine with no synchronisation between them,
    calls of two engines sharing the card (other maps) interleaved,
    one-frame and group entries mixed, and calls on a second stream beside
    the current one; every result exact."""
    engines = (_engine(False), _engine(True))
    frames = _edge_frames(12, 4096, seed=3, outside=False)
    runs = []
    for eng in engines:
        kw, _, _ = _group_view(eng)
        staged = stage_compact_group(frames, 4096, eng.compact_layout, device=cuda)
        batch = EventBatch.stack_structured(frames, 4096, device=cuda)
        t_bin = scale_time(batch.t, batch.valid, eng.cfg.t_px_scale)
        runs.append((
            lambda eng=eng, kw=kw, staged=staged: event_disparity_scatter_staged_group(
                staged, eng.compact_layout, eng.tables, **kw),
            event_disparity_scatter_staged_group_plain(staged, eng.compact_layout, eng.tables,
                                                       **kw)))
        one, bins = batch.frame(0), t_bin[0]
        ref = event_disparity_scatter_plain(one, bins, eng.tables, **kw)
        runs.append((
            lambda eng=eng, kw=kw, one=one, bins=bins: event_disparity_scatter(
                one, bins, eng.tables, **kw),
            EventScatterResult(ref.packed_map[None], ref.num_inliers[None])))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    got = []
    for rep in range(3):
        for fn, _ in runs:
            got.append(fn())
        with torch.cuda.stream(side):
            got.append(runs[rep % len(runs)][0]())
    torch.cuda.synchronize()
    want = []
    for rep in range(3):
        want += [ref for _, ref in runs] + [runs[rep % len(runs)][1]]
    for g, r in zip(got, want):
        _equal(g.packed_map.reshape(r.packed_map.shape), r.packed_map)
        _equal(g.num_inliers.reshape(r.num_inliers.shape), r.num_inliers)


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_process_frames_odd_rig_on_card(cuda, camera_perspective):
    """``process_frames`` at the odd rig (capacity 1000, ragged frames,
    kernel 2's padded output stride) equals ``process_frame`` on the card
    and the CPU port, in every output mode."""
    eng, frames = _group_rig(camera_perspective, True)
    cpu = eng.to("cpu")
    for kw in (dict(), dict(display_only=True),
               dict(display_only=True, display_packed=True)):
        outs = eng.process_frames(frames, **kw)
        for ev, got, ref in zip(frames, outs, cpu.process_frames(frames, **kw)):
            one = eng.process_frame(ev, **kw)
            for name in ("frame_bgr", "depth", "disp_map", "num_inliers"):
                _equal(getattr(got, name), getattr(ref, name))
                _equal(getattr(got, name), getattr(one, name))


def test_group_entries_check_inputs(cuda):
    eng, frames = _group_rig(False, False)
    kw, _, _ = _group_view(eng)
    cap = eng.cfg.event_capacity
    batch = EventBatch.stack_structured(frames[:2], cap, device=cuda)
    t_bin = scale_time(batch.t, batch.valid, eng.cfg.t_px_scale)
    with pytest.raises(ValueError, match="t_bin"):
        event_disparity_scatter_group(batch, t_bin.float(), eng.tables, **kw)
    with pytest.raises(ValueError, match="priority"):
        event_disparity_scatter_group(batch, t_bin, eng.tables, priority=t_bin[:1], **kw)
    staged = stage_compact_group(frames[:2], cap, eng.compact_layout, device=cuda)
    with pytest.raises(ValueError, match="counts"):
        event_disparity_scatter_staged_group(
            staged._replace(counts=staged.counts.long()), eng.compact_layout, eng.tables, **kw)
    with pytest.raises(ValueError, match="packed_crops"):
        tail_projector_group(torch.zeros((2, eng.plan.H, eng.plan.W), dtype=torch.float32,
                                         device=cuda), eng.tables, eng.plan)


# -- the scale-out layer (parallel.sharding) on a virtual mesh of the card -----


@pytest.mark.parametrize("offset", [0, 777, 524286 - 4096])
@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_event_scatter_index_offset_on_card(cuda, camera_perspective, offset):
    """Kernel 1's array and array group entries with a lane offset against
    their plain versions (keys past 2**31 at the largest); offset 0 equals
    the entry without one."""
    from xmaps_tpu_torch.ops.frame_pipeline import scatter_view

    eng = _engine(camera_perspective)
    kw = scatter_view(eng.cfg, eng.plan)
    frames = _frames()
    batch = EventBatch.stack_structured(frames, eng.cfg.event_capacity, device="cuda")
    t_bin = scale_time(batch.t, batch.valid, eng.cfg.t_px_scale)
    for f in range(len(frames)):
        one, bins = batch.frame(f), t_bin[f]
        got = event_disparity_scatter(one, bins, eng.tables, index_offset=offset, **kw)
        ref = event_disparity_scatter_plain(one, bins, eng.tables, index_offset=offset, **kw)
        torch.cuda.synchronize()
        _equal(got.packed_map, ref.packed_map)
        _equal(got.num_inliers, ref.num_inliers)
        if offset == 0:
            _equal(got.packed_map, event_disparity_scatter(one, bins, eng.tables, **kw).packed_map)
    got = event_disparity_scatter_group(batch, t_bin, eng.tables, index_offset=offset, **kw)
    ref = event_disparity_scatter_group_plain(batch, t_bin, eng.tables, index_offset=offset, **kw)
    torch.cuda.synchronize()
    _equal(got.packed_map, ref.packed_map)
    _equal(got.num_inliers, ref.num_inliers)
    if offset > 2**18:
        assert bool((got.packed_map < 0).any())  # unsigned words of 2**31 and above


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (1, 2), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_sharded_pipeline_virtual_mesh_on_card(cuda, camera_perspective, shape):
    """``make_sharded_pipeline`` on the card listed data x event times:
    every frame bit-equal to ``process_frame`` on the card and to the CPU
    port; one launch of kernel 1's group entry a mesh device and one tail
    group call a data row; ``process_frames_sharded`` at the data size."""
    from xmaps_tpu_torch.parallel import make_mesh, make_sharded_pipeline, shard_batches

    data, event = shape
    eng = _engine(camera_perspective)
    cpu = eng.to("cpu")
    calib = make_synthetic_calibration(**SIZES)
    rng = np.random.default_rng(8)
    frames = [simulate_plane_events(calib, depth_m=0.45 + 0.04 * i, subsample=0.08,
                                    jitter_us=2.0, rng=rng) for i in range(2 * data)]
    mesh = make_mesh(["cuda:0"] * (data * event), data=data, event=event)
    pipe = make_sharded_pipeline(eng.cfg, eng.tables, mesh, eng.plan)
    placed = shard_batches([eng.make_batch(ev) for ev in frames], mesh, eng.cfg)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    out = pipe(placed)
    torch.cuda.synchronize()
    tail = "colorize_camera_group" if camera_perspective else "tail_projector_group"
    assert _build.LAUNCHES["event_disparity_scatter_group"] == data * event
    assert _build.LAUNCHES[tail] == data
    for i, ev in enumerate(frames):
        for ref in (eng.process_frame(ev), cpu.process_frame(ev)):
            for a, b in zip(out, ref):
                _equal(a[i], b)
    if event == 1:
        for ev, got in zip(frames, eng.process_frames_sharded(frames[:-1], mesh)):
            for a, b in zip(got, eng.process_frame(ev)):
                _equal(a, b)


# -- more than one card: each launch on its tensors' card, meshes of cards ---


@pytest.fixture(scope="module")
def cards(cuda):
    """The number of visible cards, where there are two or more."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices ({n} visible)")
    return n


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_wrappers_launch_on_their_tensors_card(cuda, cards, camera_perspective):
    """With cuda:0 current, every kernel wrapper launches on the card its
    tensors lie on (the last one): the engine moved there (its colorize
    table built there), ``process_frame`` (kernel 1's array entry and the
    tail), ``process_staged`` (the staged entry), ``process_ring`` (the
    ring entry), ``process_frames`` (the staged group entry and the tail's
    group entry) and with a filter (the array group entry), each bit-equal
    to the CPU port; kernels A, B, W and S there equal to their plain
    versions.  Without the device guard these launches go to cuda:0's
    context with the other card's pointers and stream."""
    from xmaps_tpu_torch.apps.bench_store_loop import make_inputs
    from xmaps_tpu_torch.io.prefetch import HostStagingPool, ring_time_bounds
    from xmaps_tpu_torch.ops.esl_search import esl_disparity_search, esl_search_prep
    from xmaps_tpu_torch.ops.remap import remap_gather, remap_gather_plain
    from xmaps_tpu_torch.ops.store_loop import tile_store_last, tile_store_last_plain
    from xmaps_tpu_torch.ops.warmup import warmup_add_one, warmup_add_one_plain

    dev = torch.device("cuda", cards - 1)
    base = _engine(camera_perspective)
    cpu = base.to("cpu")
    frames = _frames()
    packed = dict(display_only=True, display_packed=True)
    with torch.cuda.device(0):
        eng = base.to(dev)
        assert eng.tables.x_map.device == dev
        assert eng.plan.table[0].device == dev
        pool = HostStagingPool(eng.cfg.event_capacity, device=dev, layout=eng.compact_layout)
        for seed, ev in enumerate(frames):
            for a, b in zip(eng.process_frame(ev), cpu.process_frame(ev)):
                _equal(a, b)
            want = cpu.process_frame(ev, **packed)
            got = eng.process_staged(pool.stage_compact(ev))
            _equal(got.frame_bgr, want.frame_bgr)
            _equal(got.num_inliers, want.num_inliers)
            rings = {d: _ring_packets(ev, 4, np.random.default_rng(seed), eng.ring_layout, d,
                                      4000) for d in (dev, "cpu")}
            _, frame, pkts, meta = rings[dev]
            got = eng.process_ring(pkts, meta, ring_time_bounds(frame, eng.cfg.event_capacity))
            ref = cpu.process_ring(*rings["cpu"][2:])
            _equal(got.frame_bgr, ref.frame_bgr)
            _equal(got.num_inliers, ref.num_inliers)
        for name in ("none", "first_per_xy"):
            eng.set_frame_filter(name)
            cpu.set_frame_filter(name)
            for g, r in zip(eng.process_frames(frames), cpu.process_frames(frames)):
                for a, b in zip(g, r):
                    _equal(a, b)
        eng.set_frame_filter("none")
        cpu.set_frame_filter("none")
        x = torch.arange(1000, dtype=torch.int32, device=dev)
        _equal(warmup_add_one(x), warmup_add_one_plain(x))
        rows, cols, vals = make_inputs(5000, (13, 3100), seed=3, device=dev)
        _equal(tile_store_last(rows, cols, vals, (13, 3100)),
               tile_store_last_plain(rows, cols, vals, (13, 3100)))
        rng = np.random.default_rng(4)
        src = torch.from_numpy(rng.random((37, 53)).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(-1, src.numel(), (31, 33)).astype(np.int32)).to(dev)
        _equal(remap_gather(src, idx), remap_gather_plain(src, idx))
        cam, proj = _monotone_case(420, 48, 420, (11, 37, 70, 300))
        prep_kw = dict(max_disp=200, row_range=(11, 37), col_range=(70, 300))
        kw = dict(prep_kw, min_disp=5)
        want = esl_disparity_search(torch.from_numpy(cam), torch.from_numpy(proj), **kw)
        prep = esl_search_prep(torch.from_numpy(proj).to(dev), **prep_kw)
        _equal(esl_disparity_search(torch.from_numpy(cam).to(dev), None, prep=prep, **kw), want)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2), (4, 1), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_sharded_pipeline_across_cards(cuda, cards, camera_perspective, shape):
    """``make_sharded_pipeline`` over distinct cards (the collectives are
    copies between cards), with and without a filter, and
    ``process_frames_sharded`` at the data size (uneven blocks): every
    frame bit-equal to ``process_frame`` on cuda:0; the tables copied once
    to each other card."""
    from xmaps_tpu_torch.parallel import make_mesh, make_sharded_pipeline, shard_batches

    data, event = shape
    if data * event > cards:
        pytest.skip(f"needs {data * event} cards ({cards} visible)")
    eng = _engine(camera_perspective)
    calib = make_synthetic_calibration(**SIZES)
    rng = np.random.default_rng(8)
    frames = [simulate_plane_events(calib, depth_m=0.45 + 0.04 * i, subsample=0.08,
                                    jitter_us=2.0, rng=rng) for i in range(2 * data)]
    mesh = make_mesh([f"cuda:{i}" for i in range(data * event)], data=data, event=event)
    assert not mesh.virtual
    for name in ("none", "first_per_xy"):
        eng.set_frame_filter(name)
        try:
            pipe = make_sharded_pipeline(eng.cfg, eng.tables, mesh, eng.plan)
            out = pipe(shard_batches([eng.make_batch(ev) for ev in frames], mesh, eng.cfg))
            assert out.frame_bgr.device == torch.device("cuda", 0)
            for i, ev in enumerate(frames):
                for a, b in zip(out, eng.process_frame(ev)):
                    _equal(a[i], b)
        finally:
            eng.set_frame_filter("none")
    if event == 1:
        got = eng.process_frames_sharded(frames[:-1], mesh)
        assert [g.frame_bgr.device.index for g in got][-1] == data - 1
        for ev, g in zip(frames, got):
            for a, b in zip(g, eng.process_frame(ev)):
                _equal(a, b)
        # one copy a card, none on the engine's own
        assert eng._replicas[torch.device("cuda", 0)][0].x_map is eng.tables.x_map
        for i in range(1, data):
            assert eng._replicas[torch.device("cuda", i)][0].x_map.device.index == i


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_bench_geometry_esl_on_card(cuda, camera_perspective, monkeypatch, tmp_path):
    """``apps.bench_geometry --geometry esl`` with 3 frames and rounds 1 2:
    one JSON line at the ESL rect, kernel 1's and the view's tail group
    entries launched once a call (the first call and 5 rounds of each
    size) and nothing else but the engine's colorize table (either view);
    the bench's group's first frame bit-equal to ``process_frame``."""
    import contextlib
    import io
    import json

    from xmaps_tpu_torch.apps import bench_geometry
    from xmaps_tpu_torch.ops.frame_pipeline import group_depth_frames

    monkeypatch.setenv("HOME", str(tmp_path))
    view = ["--camera-perspective"] if camera_perspective else []
    out = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        assert bench_geometry.main(["--geometry", "esl", "--frames", "3", "--rounds", "1", "2"]
                                   + view) == 0
    torch.cuda.synchronize()
    calls = 1 + 5 * (1 + 2)
    tail = "colorize_camera_group" if camera_perspective else "tail_projector_group"
    want = {k: 0 for k in _build.LAUNCHES}
    # the engine the bench builds builds its colorize table once, in either view
    want.update({"event_disparity_scatter_group": calls, tail: calls, "colorize_table": 1})
    assert dict(_build.LAUNCHES) == want
    doc = json.loads(out.getvalue().strip().splitlines()[-1])
    assert doc["rect"] == [5760, 3240] and doc["xmap_shape"] == [5760, 1080]
    assert doc["frame_ms"] > 0 and doc["device_ms_per_frame"] > 0
    assert 0 < doc["events_per_frame"] <= 27648 and doc["gpu"] and doc["power_limit_w"] > 0
    calib = bench_geometry.rig("esl")
    eng = XMapsDepthEngine.from_calibration(
        calib, device="cuda", event_capacity=28 * 1024, z_near=0.2, z_far=1.2,
        camera_perspective=camera_perspective,
        xmap_cache_dir=str(tmp_path / ".cache" / "xmaps_tpu_torch"))
    frames = bench_geometry.make_frames(calib, 3, 28 * 1024)
    kw = dict(display_only=True, display_packed=True)
    res = group_depth_frames(eng.stage_group(frames), eng.tables, eng.cfg, eng.plan,
                             layout=eng.compact_layout, **kw)
    one = eng.process_frame(frames[0], **kw)
    assert torch.equal(res.frame_bgr[0], one.frame_bgr)
    assert int(res.num_inliers[0]) == int(one.num_inliers) > 0


def _tool_line(main_fn, argv):
    """(return code, last JSON line) of a measurement tool's ``main``."""
    import contextlib
    import io
    import json

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_profile_trace_classifies_the_group_on_card(cuda, camera_perspective, monkeypatch,
                                                    tmp_path):
    """``apps.profile_trace`` at the demonstrator (a group of 4): every
    device kernel in its bucket, the buckets' kernels equal to the launches
    of the same calls (kernel 2 two kernels a launch), a busy share in
    (0, 1], and a scatter bucket of 0 (kernel 1 scatters its lanes)."""
    from xmaps_tpu_torch.apps import profile_trace

    monkeypatch.setenv("HOME", str(tmp_path))
    argv = ["--geometry", "demo", "--frames", "4"] + (
        ["--camera-perspective"] if camera_perspective else [])
    rc, doc = _tool_line(profile_trace.main, argv)
    assert rc == 0 and doc["classification_ok"] is True and doc["device"] == "cuda"
    tail = "colorize_camera_group" if camera_perspective else "tail_projector_group"
    assert doc["launches_per_call"] == {"event_disparity_scatter_group": 1, tail: 1}
    assert doc["expected_kernels"] == {"event_kernel": 3,
                                       "tail_kernel": 3 if camera_perspective else 6}
    assert doc["ops_per_frame"]["event_kernel"] == 0.25
    assert doc["event_kernel_us"] > 0 and doc["tail_kernel_us"] > 0 and doc["scatter_us"] == 0
    assert 0 < doc["busy_share"] <= 1
    assert doc["device_ops_total_us"] <= doc["module_total_us"]


def test_check_bitexact_demo_on_card(cuda, monkeypatch, tmp_path):
    """``apps.check_bitexact --geometry demo``: 0 failures over 2 views x 3
    depths, every entry on the card bit-equal to the CPU port."""
    from xmaps_tpu_torch.apps import check_bitexact

    monkeypatch.setenv("HOME", str(tmp_path))
    rc, doc = _tool_line(check_bitexact.main, ["--geometry", "demo"])
    assert rc == 0 and doc["value"] == 0 and doc["cases"] == 6 and doc["device"] == "cuda"


# -- kernel F: the dedup frame filters ----------------------------------------

#: (camera_width, camera_height, rect_width): the test engine's rig, the
#: demonstrator's (xy: 307,200 keys; first_per_yt: 844,800) and the ESL
#: rig's first_per_yt (2,764,800 keys)
FILTER_RIGS = {"small": (128, 96, 300), "demonstrator": (640, 480, 1760),
               "esl": (640, 480, 5760)}


def _filter_lanes(rig, frames, capacity, seed, float_t=False):
    """A stacked (frames, capacity) batch on the card with collisions,
    padding, polarities {-1, 0, 1}, an empty frame 1, and raw keys -1,
    n_keys, below -n_keys and outside the camera; and a packed camera LUT
    whose x reaches past both edges of the rectified width."""
    cw, ch, rw = FILTER_RIGS[rig]
    rng = np.random.default_rng(seed)
    fields = {k: [] for k in ("x", "y", "t", "p", "valid")}
    for f in range(frames):
        x = rng.integers(0, min(cw, 40), capacity).astype(np.int32)
        y = rng.integers(0, min(ch, 30), capacity).astype(np.int32)
        k = rng.integers(0, capacity, 50)
        x[k[:10]], y[k[:10]] = -1, 0  # raw key -1
        x[k[10:20]], y[k[10:20]] = 0, ch  # raw key n_keys
        y[k[20:30]] = -ch - 3  # below -n_keys
        x[k[30:40]] = cw + 5  # outside the camera
        y[k[40:50]] = ch + 7
        t = (np.sort(rng.random(capacity)).astype(np.float32) if float_t
             else np.sort(rng.integers(-50, 16_000, capacity)).astype(np.int32))
        valid = np.zeros(capacity, bool)
        valid[: 0 if f == 1 else capacity - capacity // 7] = True
        for key, a in zip(fields, (x, y, t, rng.choice([-1, 0, 1, 1], capacity).astype(np.int32),
                                   valid)):
            fields[key].append(a)
    batch = EventBatch(*(torch.from_numpy(np.stack(a)).cuda() for a in fields.values()),
                       count=torch.full((frames,), capacity, dtype=torch.int32, device="cuda"))
    mapx = rng.integers(-20, rw + 20, (ch, cw)).astype(np.int32)
    mapy = rng.integers(0, 100, (ch, cw)).astype(np.int32)
    lut = torch.from_numpy((mapy << 16) | (mapx & 0xFFFF)).cuda()
    return batch, lut, dict(camera_width=cw, camera_height=ch, rect_width=rw)


def _survivor_rank(prio, keep):
    """Each survivor's rank among the survivors by ``prio``; 0 elsewhere:
    kernel F's priority, given the plain version's (each row of a group on
    its own)."""
    if prio.dim() == 2:
        return torch.stack([_survivor_rank(p, k) for p, k in zip(prio, keep)])
    out = torch.zeros_like(prio)
    idx = keep.nonzero().flatten()
    out[idx[torch.argsort(prio[idx])]] = torch.arange(len(idx), dtype=prio.dtype,
                                                      device=prio.device)
    return out


def _check_filtered(got, batch, lut, kw, name):
    """Kernel F's frame(s) against the plain version on the card: keep and
    t bit-equal, the priority each survivor's rank by the plain priority
    (so order-equal over the survivors) and below the capacity."""
    from xmaps_tpu_torch.ops.filters import apply_frame_filter_plain, lut_rectified_x

    group = batch.x.dim() == 2
    frames = [batch.frame(f) for f in range(batch.x.shape[0])] if group else [batch]
    for f, b in enumerate(frames):
        xr = lut_rectified_x(b.x, b.y, lut) if name == "first_per_yt" else None
        want = apply_frame_filter_plain(b, xr, name=name, **kw)
        g = got.batch.frame(f) if group else got.batch
        prio = got.scatter_priority[f] if group else got.scatter_priority
        _equal(g.valid, want.batch.valid)
        _equal(g.t, want.batch.t)
        _equal(prio, _survivor_rank(want.scatter_priority, want.batch.valid))
        assert int(prio.max()) < b.capacity


@pytest.mark.parametrize("float_t", [False, True], ids=["int_t", "float_t"])
@pytest.mark.parametrize("rig", sorted(FILTER_RIGS))
@pytest.mark.parametrize("name", ["first_per_yt", "first_per_xy", "last_per_xy",
                                  "mean_first_last_per_xy"])
def test_frame_dedup_filter_matches_plain_on_card(cuda, name, rig, float_t):
    """Kernel F's one-frame entry on frames 0 and 1 (empty) of
    ``_filter_lanes`` and its group entry on F = 1, 7 and 12: one launch a
    call, and twice in a row (the scratch left zero)."""
    from xmaps_tpu_torch.ops.filters import apply_frame_filter, apply_frame_filter_group

    batch, lut, kw = _filter_lanes(rig, 12, 3001, seed=len(name) + len(rig), float_t=float_t)
    for f in (0, 1, 0):
        _build.reset_launch_counts()
        got = apply_frame_filter(batch.frame(f), None, name=name, cam_lut=lut, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["frame_dedup_filter"] == 1
        _check_filtered(got, batch.frame(f), lut, kw, name)
    for frames in (1, 7, 12):
        part = EventBatch(*(a[:frames] for a in batch))
        _build.reset_launch_counts()
        got = apply_frame_filter_group(part, None, name=name, cam_lut=lut, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["frame_dedup_filter_group"] == 1
        assert sum(_build.LAUNCHES.values()) == 1
        _check_filtered(got, part, lut, kw, name)


DEDUP_NAMES = ["first_per_yt", "first_per_xy", "last_per_xy", "mean_first_last_per_xy"]


@pytest.mark.parametrize("name", DEDUP_NAMES)
def test_frame_dedup_filter_long_frames_on_card(cuda, name):
    """Frames of 98,405 lanes, past the main path's capacity: kernel F
    against its plain version at the ESL rig, one frame and a group of 3
    (295,215 lanes, more than the resident grid has threads on an H100, so
    its grid-stride walk takes a lane a thread more than once), int and
    float time."""
    from xmaps_tpu_torch.ops.filters import apply_frame_filter, apply_frame_filter_group

    n = 3 * 32768 + 101
    for float_t in (False, True):
        batch, lut, kw = _filter_lanes("esl", 3, n, seed=len(name), float_t=float_t)
        got = apply_frame_filter(batch.frame(0), None, name=name, cam_lut=lut, **kw)
        _check_filtered(got, batch.frame(0), lut, kw, name)
        got = apply_frame_filter_group(batch, None, name=name, cam_lut=lut, **kw)
        _check_filtered(got, batch, lut, kw, name)


@pytest.mark.parametrize("name", DEDUP_NAMES)
def test_frame_dedup_filter_large_key_space_on_card(cuda, name):
    """An 8192 x 8192 camera (67,108,864 xy keys; first_per_yt over an
    8200-wide rectified width): kernel F equals its plain version, one
    frame and a group of 3, int and float time, and leaves its scratch
    zero."""
    from xmaps_tpu_torch.ops import filters as F

    FILTER_RIGS["large_keys"] = (8192, 8192, 8200)
    try:
        for float_t in (False, True):
            batch, lut, kw = _filter_lanes("large_keys", 3, 5003, seed=7 + len(name),
                                           float_t=float_t)
            got = F.apply_frame_filter(batch.frame(0), None, name=name, cam_lut=lut, **kw)
            _check_filtered(got, batch.frame(0), lut, kw, name)
            got = F.apply_frame_filter_group(batch, None, name=name, cam_lut=lut, **kw)
            _check_filtered(got, batch, lut, kw, name)
            torch.cuda.synchronize()
            zeroed = F._SCRATCH[(batch.x.device, torch.cuda.current_stream())][0]
            assert int(zeroed.count_nonzero()) == 0
    finally:
        del FILTER_RIGS["large_keys"]


def test_frame_dedup_filter_sequence_on_one_stream_on_card(cuda):
    """Filters A, B, A on one stream (and across key spaces: the
    demonstrator, the ESL rig, the demonstrator): each call equals its
    plain version, A's second call its first, and the scratch is zero
    after each; one kernel F launch a call and nothing else of ours."""
    from xmaps_tpu_torch.ops import filters as F

    seq = [("demonstrator", "first_per_yt"), ("demonstrator", "mean_first_last_per_xy"),
           ("demonstrator", "first_per_yt"), ("esl", "first_per_yt"),
           ("demonstrator", "first_per_xy")]
    first = {}
    for rig, name in seq:
        batch, lut, kw = _filter_lanes(rig, 1, 28672, seed=3)
        one = batch.frame(0)
        _build.reset_launch_counts()
        got = F.apply_frame_filter(one, None, name=name, cam_lut=lut, **kw)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"frame_dedup_filter": 1}
        _check_filtered(got, one, lut, kw, name)
        zeroed = F._SCRATCH[(one.x.device, torch.cuda.current_stream())][0]
        assert int(zeroed.count_nonzero()) == 0
        out = (got.batch.valid, got.batch.t, got.scatter_priority)
        if (rig, name) in first:
            for a, b in zip(out, first[(rig, name)]):
                _equal(a, b)
        first[(rig, name)] = [a.clone() for a in out]


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_filter_events_is_one_kernel_f_launch_on_card(cuda, camera_perspective):
    """``filter_events`` on the card: one ``frame_dedup_filter`` launch a
    frame (one ``frame_dedup_filter_group`` a group) and nothing else of
    ours; under the profiler no torch sort and no ``scatter_reduce``; the
    results equal the CPU port's filters (keep and t exact, priority
    order-equal over the survivors); ``process_frames`` with each filter
    equals the CPU port's."""
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES
    from xmaps_tpu_torch.ops.frame_pipeline import filter_events
    from xmaps_tpu_torch.utils.synthetic import with_events_outside_camera

    eng = _engine(camera_perspective)
    cpu = eng.to("cpu")
    cfg = eng.cfg
    rng = np.random.default_rng(3)
    frames = [with_events_outside_camera(ev, rng, cfg.camera_width, cfg.camera_height)
              for ev in _frames()]
    try:
        for name in FILTER_NAMES[1:]:
            c = cfg.replace(frame_filter=name)
            for arg in [eng.make_batch(ev) for ev in frames] + [
                    EventBatch.stack_structured(frames, cfg.event_capacity, device="cuda")]:
                _build.reset_launch_counts()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    got = filter_events(arg, eng.tables, c)
                    torch.cuda.synchronize()
                entry = "frame_dedup_filter_group" if arg.x.dim() == 2 else "frame_dedup_filter"
                assert {k: v for k, v in _build.LAUNCHES.items() if v} == {entry: 1}
                names = " ".join(e.key.lower() for e in prof.key_averages())
                assert "sort" not in names and "scatter_reduce" not in names, names
                want = filter_events(EventBatch(*(a.cpu() for a in arg)), cpu.tables, c)
                _equal(got.batch.valid, want.batch.valid)
                _equal(got.batch.t, want.batch.t)
                keep = want.batch.valid
                _equal(got.scatter_priority.cpu(),
                       _survivor_rank(want.scatter_priority, keep))
            eng.set_frame_filter(name)
            cpu.set_frame_filter(name)
            _build.reset_launch_counts()
            outs = eng.process_frames(frames)
            assert _build.LAUNCHES["frame_dedup_filter_group"] == 1
            for g, r in zip(outs, cpu.process_frames(frames)):
                for a, b in zip(g, r):
                    _equal(a, b)
    finally:
        eng.set_frame_filter("none")


def test_frame_dedup_filter_checks_inputs(cuda):
    """Kernel F's wrapper raises on what the kernel does not take: a
    capacity over MAX_CAPACITY, a wrong dtype, a non-contiguous lane array,
    first_per_yt without the LUT or with one on another device."""
    from xmaps_tpu_torch.ops.filters import apply_frame_filter, apply_frame_filter_group

    batch, lut, kw = _filter_lanes("small", 2, 64, seed=1)
    one = batch.frame(0)
    cases = [
        (one._replace(x=one.x.long()), "first_per_xy", lut, "x must be"),
        (one._replace(t=one.t.double()), "mean_first_last_per_xy", lut, "t must be"),
        (EventBatch(*(a.t().contiguous().t() for a in batch[:5]), count=batch.count),
         "last_per_xy", lut, "not contiguous"),
        (one, "first_per_yt", None, "cam_lut"),
        (one, "first_per_yt", lut.cpu(), "every tensor"),
    ]
    big = torch.zeros(524287, dtype=torch.int32, device="cuda")
    cases.append((EventBatch(big, big, big, big, big.bool(), big[0]), "first_per_xy", lut,
                  "capacity 524287"))
    for b, name, lt, match in cases:
        apply = apply_frame_filter_group if b.x.dim() == 2 else apply_frame_filter
        with pytest.raises(ValueError, match=match):
            apply(b, None, name=name, cam_lut=lt, **kw)


# -- kernel R: ESL's refinement at the ESL rig -----------------------------------


@pytest.fixture(scope="module")
def esl_gt(cuda, tmp_path_factory):
    """The ``esl-gt`` configuration's engine on the card (maps built into a
    temporary cache), 12 of its scans and their (depth0, filled image) on
    the card, as the engine hands them to the refinement."""
    import json
    from pathlib import Path

    from benchmark.kinds import scans as scan_kind
    from test_torch_esl_engine import calibration
    from xmaps_tpu_torch.models.esl_pipeline import ESLDepthEngine, normalize_scan

    cfg = json.loads((Path(__file__).resolve().parent.parent / "benchmark" / "configs"
                      / "esl_gt.json").read_text())
    eng = ESLDepthEngine.from_calibration(
        calibration(cfg["rig"]), "cuda", maps_cache_dir=str(tmp_path_factory.mktemp("esl_maps")))
    scans = scan_kind.make_scans(cfg, {"groups": 1, "scans_per_group": 12}, 2**31 + 77)
    planes = eng.process_scans(scans, refine=False, fetch=False)
    cam = torch.from_numpy(np.stack([normalize_scan(s) for s in scans])).cuda()
    fill = torch.ones_like(cam[:, 0, 0]) / cam[:, 0, 0]
    img = torch.where(cam == 0, fill[:, None, None], cam)
    return eng, scans, planes.depth_init.contiguous(), img.contiguous()


def _esl_plan(eng, window_size, **fields):
    from xmaps_tpu_torch.models.esl_pipeline import RefinePlan

    plan = RefinePlan(eng.maps.calib, eng.maps, window_size, eng.plan.proj_w, eng.plan.proj_h)
    for k, v in fields.items():
        setattr(plan, k, v)
    return plan


def _bits_equal(a, b):
    """Bit for bit (NaNs included), float32 of one shape."""
    assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
    assert torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.parametrize("window_size,iters", [(7, 64), (5, 50)], ids=["w3_64", "w2_50"])
@pytest.mark.parametrize("F", [1, 5, 12])
def test_esl_refine_kernel_matches_plain_on_card(esl_gt, F, window_size, iters):
    """Kernel R on F scans of the ESL rig (one launch) against its plain
    version on the card, bit for bit, and each scan of the group against
    the kernel's one-scan call."""
    from xmaps_tpu_torch.ops.esl_refine import esl_refine, esl_refine_plain

    eng, _, depth, img = esl_gt
    plan = _esl_plan(eng, window_size)
    d, im = depth[:F].contiguous(), img[:F].contiguous()
    _build.reset_launch_counts()
    got = esl_refine(d, im, plan, iters)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"esl_refine": 1}
    want = esl_refine_plain(d, im, plan, iters)
    _bits_equal(got, want)
    assert (want > 0).sum() > 50_000 * F and ((want != d) & (want > 0)).sum() > 50_000 * F
    for f in (0, F - 1):
        _bits_equal(got[f], esl_refine(d[f].contiguous(), im[f].contiguous(), plan, iters))


@pytest.mark.parametrize("distorted", [False, True], ids=["plain_projector", "distorted"])
def test_esl_refine_kernel_crafted_pixels_on_card(esl_gt, distorted):
    """Pixels that take the kernel down its rare paths, bit-equal to the
    plain version on the card: a translation along x only and p03 = 256 put
    depth 256's first sample at depth 0 (zp == 0, x_proj beyond int32, the
    bounds test wrapping), huge depths (casts saturating), depth <= 0 and
    NaN, the region's border lit, an all-lit scan; with and without the
    projector's distortion."""
    from xmaps_tpu_torch.ops.esl_refine import esl_refine, esl_refine_plain

    eng, _, depth, img = esl_gt
    fields = dict(T=np.array([eng.plan.T[0], 0, 0], np.float32), p03=256.0)
    if distorted:
        fields["proj_D"] = np.array([-0.11, 0.07, 0.0013, -0.0021, 0.015], np.float32)
    plan = _esl_plan(eng, 7, **fields)
    d, im = depth[:3].clone(), img[:3].clone()
    d[0, 200:230, 300:340] = 256.0
    im[0, 190:240, 290:350] = 0.05
    d[0, 10, 10:15] = torch.tensor([-1.0, 0.0, -0.0, 1e-30, float("nan")])
    d[1, 300:320, 5:30] = 1e18
    d[1, 7, :] = d[1, :, 7] = d[1, -8, :] = d[1, :, -8] = 0.5
    d[2] = torch.where(d[2] > 0, d[2], torch.full_like(d[2], 0.5))
    got = esl_refine(d, im, plan)
    want = esl_refine_plain(d, im, plan)
    _bits_equal(got, want)
    assert (want[0, 200:230, 300:340] >= 0).all() and (want[2, 7:-7, 7:-7] > 0).all()


def test_esl_engine_group_is_one_kernel_r_launch_on_card(esl_gt, monkeypatch):
    """``process_scans`` of 12 scans: one ``esl_refine`` launch (and kernels
    A and B a scan); each scan equal to its one-scan call; its refined plane
    equal to the plain version on the card; and on the device, inside the
    ``esl.refine`` span, the refinement itself is one kernel R and nothing
    else, beside only the empty pixels' fill (its few elementwise kernels
    before it, whatever F)."""
    from xmaps_tpu_torch.models import esl_pipeline
    from xmaps_tpu_torch.ops.esl_refine import esl_refine_plain
    from xmaps_tpu_torch.ops.warmup import warmup_add_one
    from xmaps_tpu_torch.utils.profiling import device_events

    eng, scans, depth, img = esl_gt
    _build.reset_launch_counts()
    planes = eng.process_scans(scans)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "esl_refine": 1, "esl_disparity_search": 12, "remap_gather": 24, "esl_denoise": 21}
    _bits_equal(planes.depth_optim.cuda(), esl_refine_plain(depth, img, eng.plan, 64))
    for f in (0, 11):
        one = eng.process_scans(scans[f:f + 1])
        for a, b in zip(planes, one):
            _bits_equal(a[f], b[0])

    # warm-up kernel W launches mark the span's and the refinement's ends
    tick = torch.zeros(8, dtype=torch.int32, device="cuda")
    span, refine = esl_pipeline.span, esl_pipeline.depth_optimization_dense

    def marked_span(name, tag=None):
        if name != "esl.refine":
            return span(name, tag)

        @contextlib.contextmanager
        def marked():
            with span(name, tag):
                warmup_add_one(tick)
                yield
                warmup_add_one(tick)
        return marked()

    def marked_refine(*args, **kw):
        warmup_add_one(tick)
        out = refine(*args, **kw)
        warmup_add_one(tick)
        return out

    monkeypatch.setattr(esl_pipeline, "span", marked_span)
    monkeypatch.setattr(esl_pipeline, "depth_optimization_dense", marked_refine)
    for group in (scans, scans[:1]):
        names = [e[0] for e in device_events(lambda: eng.process_scans(group), 1)]
        marks = [i for i, n in enumerate(names) if "warmup_add_one" in n]
        assert len(marks) == 4, names
        fill, kernel, after = (names[a + 1:b] for a, b in zip(marks, marks[1:]))
        assert len(kernel) == 1 and "esl_refine_kernel" in kernel[0] and not after, (kernel,
                                                                                     after)
        assert 1 <= len(fill) <= 4 and all("at::native" in n for n in fill), fill


# -- kernel D: ESL's denoise at the ESL rig ----------------------------------------

#: the TV sweeps' divisor at the eval's parameters (mu + 4 lam)
ESL_DIAG = denoise_scalars(3.0, 3.0, 0.5, 0.1)["diag"]


def _denoise_params(**kw):
    from xmaps_tpu_torch.models.esl_pipeline import BILATERAL, TV_DENOISE

    return {**BILATERAL, **TV_DENOISE, **kw}


def _denoise_plain(x, d, sigma_color, sigma_space, **tv):
    from xmaps_tpu_torch.ops.esl_denoise import bilateral_filter, tv_denoise_split_bregman

    return tv_denoise_split_bregman(bilateral_filter(x, d, sigma_color, sigma_space), **tv)


@pytest.fixture(scope="module")
def esl_optim(esl_gt):
    """The 12 scans' refined plane (kernel R), (12, 480, 640) on the card."""
    from xmaps_tpu_torch.ops.esl_refine import esl_refine

    eng, _, depth, img = esl_gt
    return esl_refine(depth, img, eng.plan, 64)


@pytest.mark.parametrize("F", [1, 12])
def test_esl_denoise_kernel_matches_plain_on_card(esl_optim, F):
    """Kernel D on F refined scans of the ESL rig (1 + 20 launches) against
    the plain versions on the card, bit for bit, and the one-scan (H, W)
    call against the group's scan."""
    from xmaps_tpu_torch.ops.esl_denoise import esl_denoise

    optim = esl_optim[:F].contiguous()
    _build.reset_launch_counts()
    got = esl_denoise(optim, **_denoise_params())
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"esl_denoise": 21}
    want = _denoise_plain(optim, **_denoise_params())
    _bits_equal(got, want)
    assert (optim > 0).sum() > 50_000 * F and (got != optim).sum() > 100_000 * F
    _bits_equal(got[F - 1], esl_denoise(optim[F - 1].contiguous(), **_denoise_params()))


def _depth_like(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(shape, generator=g, device="cuda") + 0.3
    x = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.3, 0.0, x)
    x[..., : shape[-2] // 2, :] += 0.5
    return x.contiguous()


@pytest.mark.parametrize("case", ["cell", "odd", "row", "column", "one_scan", "constant",
                                  "widest", "few_sweeps", "special_values"])
def test_esl_denoise_kernel_edges_on_card(cuda, case):
    """Kernel D bit-equal to the plain versions on the card: the cell's
    shape with depth-like inputs (zeros where undefined), sizes smaller
    than and not dividing the tiles, an (H, W) input, a constant image, the
    widest window and halo the tiles hold, other counts, and inf / NaN /
    -0 / huge depths (compared bit for bit, NaNs included)."""
    from xmaps_tpu_torch.ops.esl_denoise import MAX_INNER, MAX_RADIUS, esl_denoise

    params = _denoise_params()
    if case == "cell":
        x = _depth_like((12, 480, 640), 1)
    elif case == "odd":
        x = _depth_like((3, 33, 21), 2)
    elif case == "row":
        x = _depth_like((2, 1, 5), 3)
    elif case == "column":
        x = _depth_like((2, 7, 1), 4)
    elif case == "one_scan":
        x = _depth_like((97, 131), 5)
    elif case == "constant":
        x = torch.full((2, 70, 90), 0.731, device="cuda")
    elif case == "widest":
        x = _depth_like((2, 100, 150), 6)
        params = _denoise_params(d=2 * MAX_RADIUS + 1, sigma_color=0.05, sigma_space=7.0,
                                 niter=3, niter_inner=MAX_INNER, mu=0.9, eps=0.3)
    elif case == "few_sweeps":
        x = _depth_like((2, 100, 150), 7)
        params = _denoise_params(d=3, niter=2, niter_inner=1)
    else:
        x = _depth_like((2, 64, 96), 8)
        x[0, 5, 5:10] = torch.tensor([float("inf"), float("nan"), -0.0, 1e30, -1e-40])
        x[1, 40:44, 60:70] = 3e19
    _build.reset_launch_counts()
    got = esl_denoise(x, **params)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["esl_denoise"] == 1 + params["niter"]
    _bits_equal(got, _denoise_plain(x, **params))


def _every_float(fn, want_fn, chunk=1 << 28):
    """``fn`` against ``want_fn`` on every float32 bit pattern, in chunks:
    equal bits where the wanted value is a number, NaN where it is NaN."""
    for lo in range(-(1 << 31), 1 << 31, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int32, device="cuda").view(torch.float32)
        want, got = want_fn(x), fn(x)
        nan = torch.isnan(want)
        assert torch.equal(nan, torch.isnan(got)), lo
        assert torch.equal(torch.where(nan, 0, want.view(torch.int32)),
                           torch.where(nan, 0, got.view(torch.int32))), lo
        del x, want, got, nan


def _probe(entry, x, *args):
    """One of kernel D's test entries on the contiguous float32 CUDA ``x``."""
    out = torch.empty_like(x)
    _build.launch(x.device, "esl_denoise", entry, x.data_ptr(), x.numel(), *args,
                  out.data_ptr())
    return out


def test_esl_denoise_weight_is_torch_exp_on_card(cuda):
    """The bilateral's weight function (``expf`` in kernel D) against
    ``torch.exp`` on every float32 bit pattern."""
    _every_float(lambda x: _probe("esl_denoise_exp", x), torch.exp)


@pytest.mark.parametrize("d", [ESL_DIAG, 1.0, 0.75, 3.3, 1.9999999, 2.0 ** -20, 2.0 ** 20,
                               0.0017])
def test_esl_denoise_sweep_division_on_card(cuda, d):
    """The sweeps' division by diag (a reciprocal and two corrections,
    subnormal quotients rounded by their residual) against torch's division
    by a float32 tensor on the card (a true division, as the plain version
    divides by its 0-d ``diag``), on every float32 bit pattern; the first d
    is the eval's diag."""
    d = float(np.float32(d))
    dt = torch.full((), d, dtype=torch.float32, device="cuda")
    _every_float(lambda x: _probe("esl_denoise_quotient", x, d), lambda x: x / dt)


def test_esl_engine_denoise_is_kernel_d_on_card(esl_gt, monkeypatch):
    """``process_scans`` of 12 scans and of 1: its filtered plane equal to
    the plain versions on the card, 21 ``esl_denoise`` launches a call
    whatever F, and on the device, inside the ``esl.denoise`` span, kernel
    D's 21 kernels (the bilateral, then 20 TV iterations) and nothing else."""
    from xmaps_tpu_torch.models import esl_pipeline
    from xmaps_tpu_torch.ops.warmup import warmup_add_one
    from xmaps_tpu_torch.utils.profiling import device_events

    eng, scans, _, _ = esl_gt
    for group in (scans, scans[:1]):
        _build.reset_launch_counts()
        planes = eng.process_scans(group)
        assert _build.LAUNCHES["esl_denoise"] == 21
        _bits_equal(planes.depth_optim_filtered.cuda(),
                    _denoise_plain(planes.depth_optim.cuda(), **_denoise_params()))

    tick = torch.zeros(8, dtype=torch.int32, device="cuda")
    span = esl_pipeline.span

    def marked_span(name, tag=None):
        if name != "esl.denoise":
            return span(name, tag)

        @contextlib.contextmanager
        def marked():
            with span(name, tag):
                warmup_add_one(tick)
                yield
                warmup_add_one(tick)
        return marked()

    monkeypatch.setattr(esl_pipeline, "span", marked_span)
    for group in (scans, scans[:1]):
        names = [e[0] for e in device_events(lambda: eng.process_scans(group), 1)]
        marks = [i for i, n in enumerate(names) if "warmup_add_one" in n]
        assert len(marks) == 2, names
        inside = names[marks[0] + 1:marks[1]]
        assert len(inside) == 21 and "esl_bilateral_kernel" in inside[0] and all(
            "esl_tv_kernel" in n for n in inside[1:]), inside
