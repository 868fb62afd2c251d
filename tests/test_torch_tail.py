"""Kernels 2 and 3 (plain versions) vs the JAX Pallas tail kernels.

``tail_projector`` and ``colorize_camera`` on CPU tensors run their plain
PyTorch versions; they are held against ``pallas_tail`` and
``pallas_colorize`` run in interpret mode with ``pack=PACK``, for every
output variant.  Frames, depth and disparity are compared exactly.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xmaps_tpu.calib.maps import CamProjMaps  # noqa: E402
from xmaps_tpu.ops import pallas_tail as jpt  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration  # noqa: E402

from xmaps_tpu_torch.ops.cuda_tail import (  # noqa: E402
    CamTailPlan,
    build_tail_plan,
    colorize_camera,
    colorize_table_plain,
    tail_projector,
    tail_projector_group,
    tail_projector_plain,
    with_colorize_table,
)
from xmaps_tpu_torch.ops.frame_pipeline import DeviceTables  # noqa: E402
from xmaps_tpu_torch.ops.scatter import PACK  # noqa: E402

torch.set_num_threads(1)

Z_NEAR, Z_FAR = 0.2, 1.2
VARIANTS = [
    dict(emit_aux=True, packed_bgr=False),
    dict(emit_aux=False, packed_bgr=False),
    dict(emit_aux=False, packed_bgr=True),
]
VARIANT_IDS = ["aux", "display", "display_packed"]
RIGS = {
    "default": {},
    "graft": dict(camera_width=128, camera_height=96, projector_width=180, projector_height=320),
}


@functools.lru_cache(maxsize=None)
def _rig(name):
    calib = make_synthetic_calibration(**RIGS[name])
    maps = CamProjMaps(calib)
    p03 = float(maps.P2[0, 3])
    args = (maps.disp_proj_mapx_i16, maps.disp_proj_mapy_i16,
            calib.rect_image_height, calib.rect_image_width)
    jplan = jpt.build_tail_plan(*args, p03=p03, z_near=Z_NEAR, z_far=Z_FAR)
    tplan = build_tail_plan(*args, p03=p03, z_near=Z_NEAR, z_far=Z_FAR)
    tables = DeviceTables.from_maps(maps, np.zeros((1, 1), np.int16), "cpu")
    return calib, maps, jplan, tplan, tables


@pytest.fixture(params=sorted(RIGS))
def rig(request):
    return _rig(request.param)


def _packed_map(shape, seed, density=0.03):
    """A scattered packed map: (priority + 1) * PACK + disp, disp in
    [0, 160) (0 included: a kept event of disparity 0)."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.int64)
    hit = rng.random(shape) < density
    m[hit] = (rng.integers(0, 4096, hit.sum()) + 1) * PACK + rng.integers(0, 160, hit.sum())
    return m


def _check(got, ref, variant):
    frame, depth, disp = got
    rframe, rdepth, rdisp = ref
    if variant["packed_bgr"]:
        assert frame.dtype == torch.int32
        np.testing.assert_array_equal(
            frame.numpy().astype(np.int64), np.asarray(rframe).astype(np.int64)
        )
    else:
        assert frame.dtype == torch.uint8
        np.testing.assert_array_equal(frame.numpy(), np.asarray(rframe))
    if variant["emit_aux"]:
        np.testing.assert_array_equal(depth.numpy(), np.asarray(rdepth))
        np.testing.assert_array_equal(disp.numpy(), np.asarray(rdisp))
    else:
        assert depth is None and disp is None and rdepth is None and rdisp is None


def test_tail_plan_crop_matches_jax(rig):
    calib, maps, jplan, tplan, tables = rig
    for f in ("full_H", "full_W", "crop_row0", "crop_col0", "H", "W", "p03", "z_near", "z_far"):
        assert getattr(tplan, f) == getattr(jplan, f), f


@pytest.mark.parametrize(
    "rig_name,variant",
    [("default", v) for v in VARIANTS] + [("graft", VARIANTS[0])],
    ids=[f"default-{i}" for i in VARIANT_IDS] + ["graft-aux"],
)
def test_tail_projector_matches_pallas(rig_name, variant):
    """Every variant at the default rig; the wider graft rig (an interpret
    run there takes ~10 s) with the full outputs."""
    calib, maps, jplan, tplan, tables = _rig(rig_name)
    crop = _packed_map((tplan.H, tplan.W), seed=tplan.H)
    padded = np.zeros((jplan.H_pad, jplan.W_pad), np.uint32)
    padded[: tplan.H, : tplan.W] = crop
    ref = jpt.pallas_tail(jnp.asarray(padded), jplan, interpret=True, pack=PACK, **variant)
    got = tail_projector(torch.from_numpy(crop.astype(np.int32)), tables, tplan, **variant)
    _check(got, ref, variant)
    assert tuple(got[0].shape[:2]) == (calib.projector_height, calib.projector_width)


def _tiny_crop_rig():
    """A 7-row, 11-column rect frame (narrower and shorter than one 32 x 16
    dilate tile of the CUDA kernel, wider than one 7 x 7 window) seen by a
    9 x 13 projector (117 pixels, not a multiple of 8) whose maps overshoot
    the frame by one pixel on every side; one source row per projector
    row, as a rectification gives."""
    Hp, Wp, full_H, full_W = 9, 13, 7, 11
    ii, jj = np.meshgrid(np.arange(Hp), np.arange(Wp), indexing="ij")
    mapx = (jj * (full_W + 2) // Wp - 1).astype(np.int16)
    mapy = (ii * (full_H + 2) // Hp - 1).astype(np.int16)
    p03 = 40.0
    args = (mapx, mapy, full_H, full_W)
    jplan = jpt.build_tail_plan(*args, p03=p03, z_near=Z_NEAR, z_far=Z_FAR)
    tplan = build_tail_plan(*args, p03=p03, z_near=Z_NEAR, z_far=Z_FAR)
    zero = np.zeros((1, 1), np.int16)
    tables = DeviceTables.from_numpy(zero, zero, zero, mapx, mapy, p03, "cpu")
    return jplan, tplan, tables


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_tail_projector_crop_smaller_than_a_tile(variant):
    jplan, tplan, tables = _tiny_crop_rig()
    assert (tplan.H, tplan.W) == (7, 11) == (jplan.H, jplan.W)
    crop = _packed_map((tplan.H, tplan.W), seed=11, density=0.15)
    crop[1, 2] = 4095 * PACK + 170  # high priority bits, the largest disparity
    padded = np.zeros((jplan.H_pad, jplan.W_pad), np.uint32)
    padded[: tplan.H, : tplan.W] = crop
    ref = jpt.pallas_tail(jnp.asarray(padded), jplan, interpret=True, pack=PACK, **variant)
    got = tail_projector(torch.from_numpy(crop.astype(np.int32)), tables, tplan, **variant)
    _check(got, ref, variant)
    assert tuple(got[0].shape[:2]) == (9, 13)
    if variant["emit_aux"]:  # windows differ, and zeros outside the frame
        assert (got[2] == 170).any() and len(torch.unique(got[2])) >= 3


def test_tail_projector_empty_map():
    calib, maps, jplan, tplan, tables = _rig("default")
    empty = torch.zeros((tplan.H, tplan.W), dtype=torch.int32)
    frame, depth, disp = tail_projector(empty, tables, tplan)
    ref = jpt.pallas_tail(
        jnp.zeros((jplan.H_pad, jplan.W_pad), jnp.uint32), jplan, interpret=True, pack=PACK
    )
    _check((frame, depth, disp), ref, VARIANTS[0])
    assert (depth == 0).all() and (frame == 255).all()  # all undefined -> white


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_colorize_camera_matches_pallas(rig, variant):
    calib, maps, jplan, tplan, tables = rig
    H, W = calib.camera_height, calib.camera_width
    jcam = jpt.build_cam_tail_plan(H, W, p03=float(maps.P2[0, 3]), z_near=Z_NEAR, z_far=Z_FAR)
    tcam = CamTailPlan(H=H, W=W, p03=jcam.p03, z_near=Z_NEAR, z_far=Z_FAR)
    packed = _packed_map((H, W), seed=W, density=0.3)
    padded = np.zeros((jcam.H_pad, jcam.W_pad), np.uint32)
    padded[:H, :W] = packed
    ref = jpt.pallas_colorize(jnp.asarray(padded), jcam, interpret=True, pack=PACK, **variant)
    got = colorize_camera(torch.from_numpy(packed.astype(np.int32)), tables, tcam, **variant)
    _check(got, ref, variant)


def test_packed_bgr_requires_display_only():
    calib, maps, jplan, tplan, tables = _rig("default")
    m = torch.zeros((tplan.H, tplan.W), dtype=torch.int32)
    with pytest.raises(ValueError, match="display-only"):
        tail_projector(m, tables, tplan, emit_aux=True, packed_bgr=True)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_colorize_camera_every_disparity_matches_pallas(variant):
    """Each disparity 0 .. PACK - 1 once, in a (64, 128) map of words with
    random priority bits above PACK (bit 31 included): everything the
    colorize table of the CUDA kernel holds."""
    calib, maps, jplan, tplan, tables = _rig("default")
    H, W = 64, 128
    assert H * W == PACK
    rng = np.random.default_rng(8192)
    disp = rng.permutation(PACK).astype(np.uint64)
    words = (rng.integers(0, 2**32 // PACK, PACK).astype(np.uint64) * PACK + disp)
    packed = words.astype(np.uint32).reshape(H, W)
    assert (packed >= 2**31).any()
    jcam = jpt.build_cam_tail_plan(H, W, p03=float(maps.P2[0, 3]), z_near=Z_NEAR, z_far=Z_FAR)
    tcam = CamTailPlan(H=H, W=W, p03=jcam.p03, z_near=Z_NEAR, z_far=Z_FAR)
    padded = np.zeros((jcam.H_pad, jcam.W_pad), np.uint32)
    padded[:H, :W] = packed
    ref = jpt.pallas_colorize(jnp.asarray(padded), jcam, interpret=True, pack=PACK, **variant)
    got = colorize_camera(torch.from_numpy(packed.view(np.int32)), tables, tcam, **variant)
    _check(got, ref, variant)
    if variant["emit_aux"]:
        np.testing.assert_array_equal(np.sort(got[2].numpy().ravel()), np.arange(PACK))


def test_cpu_projector_plan_holds_no_table():
    """On the CPU ``with_colorize_table`` leaves a projector plan without a
    table (dropping one it held), and ``tail_projector`` still runs the
    plain chain, bit-equal to ``pallas_tail`` in interpret mode."""
    import dataclasses

    calib, maps, jplan, tplan, tables = _rig("default")
    plan = with_colorize_table(tplan, tables)
    assert plan.table is None and plan == tplan
    held = dataclasses.replace(tplan, table=colorize_table_plain(tables, tplan))
    assert with_colorize_table(held, tables).table is None
    crop = _packed_map((tplan.H, tplan.W), seed=5)
    padded = np.zeros((jplan.H_pad, jplan.W_pad), np.uint32)
    padded[: tplan.H, : tplan.W] = crop
    for variant in VARIANTS:
        ref = jpt.pallas_tail(jnp.asarray(padded), jplan, interpret=True, pack=PACK, **variant)
        _check(tail_projector(torch.from_numpy(crop.astype(np.int32)), tables, plan, **variant),
               ref, variant)


@pytest.mark.parametrize("geometry", ["demo", "esl"])
def test_projector_plan_p03_is_the_tables_p03(geometry, monkeypatch):
    """The card's colorize table is built from ``plan.p03`` (passed to the
    kernel as float32); the plain chain divides by ``tables.p03`` (float32).
    At both rigs of ``apps.bench_geometry``, the engine's construction
    (``build_tail_plan`` and ``DeviceTables.from_maps`` of one
    ``CamProjMaps``) gives the two the same float32.  The rect-sized
    undistortion maps, which neither reads, are stubbed to keep the ESL
    rig's 5760 x 3240 frame off the CPU."""
    from xmaps_tpu_torch.apps.bench_geometry import rig
    from xmaps_tpu_torch.calib import maps as tmaps

    monkeypatch.setattr(tmaps, "init_undistort_rectify_map",
                        lambda *a: (np.zeros((1, 1), np.float32),) * 2)
    calib = rig(geometry)
    maps = tmaps.CamProjMaps(calib)
    plan = build_tail_plan(maps.disp_proj_mapx_i16, maps.disp_proj_mapy_i16,
                           calib.rect_image_height, calib.rect_image_width,
                           p03=float(maps.P2[0, 3]), z_near=Z_NEAR, z_far=Z_FAR)
    tables = DeviceTables.from_maps(maps, np.zeros((1, 1), np.int16), "cpu")
    assert tables.p03.dtype == torch.float32
    assert torch.equal(torch.tensor(plan.p03, dtype=torch.float32), tables.p03)
    assert plan.p03 > 100  # a real baseline x focal, not a default


def _every_disparity_rig():
    """A 364 x 364 rect frame, all of it the crop, with a 91 x 91 grid of
    points 4 pixels apart (at 4 i + 2, 4 j + 2) and a 91 x 91 projector
    whose pixel (i, j) samples point (i, j).  Every other pixel holds
    disparity 0, and no point lies in another's 7 x 7 window, so the
    dilated value at a point is its own disparity.  Points 0 .. PACK - 1
    hold the disparities 0 .. PACK - 1 in a random order, the other 89
    repeat some; every word has random priority bits above PACK (bit 31
    among them)."""
    n, step = 91, 4
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mapx = (step * jj + 2).astype(np.int16)
    mapy = (step * ii + 2).astype(np.int16)
    args = (mapx, mapy, n * step, n * step)
    jplan = jpt.build_tail_plan(*args, p03=40.0, z_near=Z_NEAR, z_far=Z_FAR)
    tplan = build_tail_plan(*args, p03=40.0, z_near=Z_NEAR, z_far=Z_FAR)
    zero = np.zeros((1, 1), np.int16)
    tables = DeviceTables.from_numpy(zero, zero, zero, mapx, mapy, 40.0, "cpu")
    rng = np.random.default_rng(91)
    disp = np.zeros((n * step, n * step), np.uint64)
    disp[2::step, 2::step] = np.concatenate(
        [rng.permutation(PACK), rng.integers(0, PACK, n * n - PACK)]).reshape(n, n)
    words = rng.integers(0, 2**32 // PACK, disp.shape).astype(np.uint64) * PACK + disp
    return jplan, tplan, tables, words.astype(np.uint32)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_tail_projector_every_disparity_matches_pallas(variant):
    """Each disparity 0 .. PACK - 1 through the projector tail (dilate,
    remap, epilogue): ``tail_projector_plain``, and the colorize table's
    entries (``colorize_table_plain``, what the card's kernel 2 reads) at
    the dilated disparity of each pixel, both equal to ``pallas_tail`` in
    interpret mode; the group entry too, on two crops."""
    jplan, tplan, tables, words = _every_disparity_rig()
    assert (tplan.crop_row0, tplan.crop_col0, tplan.H, tplan.W) == (0, 0, 364, 364)
    assert (words >= 2**31).any()
    padded = np.zeros((jplan.H_pad, jplan.W_pad), np.uint32)
    padded[: tplan.H, : tplan.W] = words
    ref = jpt.pallas_tail(jnp.asarray(padded), jplan, interpret=True, pack=PACK, **variant)
    crop = torch.from_numpy(words.view(np.int32))
    got = tail_projector_plain(crop, tables, tplan, **variant)
    _check(got, ref, variant)
    d = tail_projector_plain(crop, tables, tplan)[2]
    assert torch.equal(torch.unique(d), torch.arange(PACK, dtype=torch.float32))
    bgr, depth = colorize_table_plain(tables, tplan)
    idx = d.long()
    frame = bgr[idx] if variant["packed_bgr"] else torch.stack(
        [(bgr[idx] >> s) & 255 for s in (0, 8, 16)], -1).to(torch.uint8)
    aux = (depth[idx], d) if variant["emit_aux"] else (None, None)
    _check((frame, *aux), ref, variant)
    group = tail_projector_group(torch.stack([crop, torch.flip(crop, (0, 1))]), tables, tplan,
                                 **variant)
    _check(tuple(None if a is None else a[0] for a in group), ref, variant)
