"""The port's ESL disparity search (kernel A's plain version) and its
device depth init vs the JAX package.

``xmaps_tpu_torch.ops.esl_search`` against ``xmaps_tpu.ops.pallas_esl``
(Pallas in interpret mode) and against the brute force
``disparity_init_dense`` of both packages, on the cases of
``tests/test_pallas_esl.py``: value plateaus and exact ties, footprint
crops whose right edge is the frame's edge and crops whose right edge is
not, hoisted prep tables, the empty footprint.  Then
``build_device_depth_init`` (forward remap -> search -> back-gather) on the
64x48 / 90x160 synthetic rig against the JAX program in its three
variants.  Every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmaps_tpu.apps import eval_esl as jesl  # noqa: E402
from xmaps_tpu.calib.maps import CamProjMaps as JMaps  # noqa: E402
from xmaps_tpu.ops import pallas_esl as jpe  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration  # noqa: E402

from xmaps_tpu_torch.calib.maps import CamProjMaps as TMaps  # noqa: E402
from xmaps_tpu_torch.models import esl_pipeline as tesl  # noqa: E402
from xmaps_tpu_torch.ops import esl_search as tse  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration as t_calib  # noqa: E402

torch.set_num_threads(1)


def _plateau_case(trial):
    """Monotone rows, optional equal-value plateaus, exact value matches
    (tests/test_pallas_esl.py:19-41)."""
    rng = np.random.default_rng(100 + trial)
    H, W = 24, 300 + 80 * trial
    base = np.sort(rng.random((H, W)).astype(np.float32), axis=1)
    if trial % 2:
        base = np.round(base * 60) / 60  # equal-value plateaus
    mask = rng.random((H, W)) < (0.15 + 0.1 * trial)
    proj = np.where(mask, base + 1e-3, 0).astype(np.float32)
    cam = np.where(rng.random((H, W)) < 0.3, rng.random((H, W)), 0).astype(np.float32)
    cc = rng.integers(0, W - 130, 40)
    rr = rng.integers(0, H, 40)
    cam[rr, cc] = proj[rr, np.minimum(cc + 17, W - 1)]
    return cam, proj, 120 + 60 * trial


@pytest.mark.parametrize("trial", range(3))
def test_search_matches_jax_and_brute_force(trial):
    cam, proj, md = _plateau_case(trial)
    assert tse.rows_monotone(proj) and jpe.rows_monotone(proj)
    want = np.asarray(jesl.disparity_init_dense(cam, proj, min_disp=5, max_disp=md))
    jax_fast = np.asarray(
        jpe.esl_disparity_search(cam, proj, min_disp=5, max_disp=md, interpret=True)
    )
    np.testing.assert_array_equal(jax_fast, want)
    got = tse.esl_disparity_search(torch.from_numpy(cam), torch.from_numpy(proj),
                                   min_disp=5, max_disp=md)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    dense = tesl.disparity_init_dense(torch.from_numpy(cam), torch.from_numpy(proj),
                                      min_disp=5, max_disp=md)
    np.testing.assert_array_equal(dense.numpy(), want)
    assert want.any()


def _crop_case(trial):
    """Occupancy confined to an interior, unaligned window
    (tests/test_pallas_esl.py:44-88).  The box's right edge c1 + max_disp
    stays inside the frame for trial 0 and reaches its edge for 1 and 2."""
    rng = np.random.default_rng(200 + trial)
    H, W = 48, 420 + 64 * trial
    base = np.sort(rng.random((H, W)).astype(np.float32), axis=1)
    mask = rng.random((H, W)) < 0.2
    proj = np.where(mask, base + 1e-3, 0).astype(np.float32)
    cam = np.zeros((H, W), np.float32)
    r0, r1, c0, c1 = 11, 37, 70, 260 + 40 * trial
    blob = rng.random((r1 - r0, c1 - c0)).astype(np.float32)
    cam[r0:r1, c0:c1] = np.where(blob < 0.4, blob, 0)
    md = 150 + 50 * trial
    return cam, proj, (r0, r1), (c0, c1), md


@pytest.mark.parametrize("trial", range(3))
def test_search_footprint_crop_and_prep_match_jax(trial):
    cam, proj, rows, cols, md = _crop_case(trial)
    H, W = cam.shape
    edge = cols[1] + md >= W
    assert edge == (trial > 0)
    prep_kw = dict(max_disp=md, row_range=rows, col_range=cols)
    kw = dict(prep_kw, min_disp=5)
    # the JAX package's own tests pin its crop equal to its full search
    want = np.asarray(jpe.esl_disparity_search(cam, proj, interpret=True, **kw))
    tcam, tproj = torch.from_numpy(cam), torch.from_numpy(proj)
    np.testing.assert_array_equal(
        tse.esl_disparity_search(tcam, tproj, min_disp=5, max_disp=md).numpy(), want)
    np.testing.assert_array_equal(tse.esl_disparity_search(tcam, tproj, **kw).numpy(), want)
    assert want.any()

    # the prep tables equal the JAX package's (its rows are padded to 8)
    jprep = jpe.esl_search_prep(proj, **kw)
    tprep = tse.esl_search_prep(tproj, **prep_kw)
    for name, a, b in zip("GFNRC", tprep, jprep):
        b = np.asarray(b)[: a.shape[0]]
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    np.testing.assert_array_equal(
        tse.esl_disparity_search(tcam, None, prep=tprep, **kw).numpy(), want)

    # pre-cropped inputs (full_shape) emitting the box only
    r0, r1, c0, c1 = tse.footprint_box((H, W), rows, cols, md)
    assert (r0, r1, c0, c1) == jpe.footprint_box((H, W), rows, cols, md)
    assert (c1 == W) == edge
    pk = dict(kw, full_shape=(H, W))
    box_prep = tse.esl_search_prep(tproj[r0:r1, c0:c1], **prep_kw, full_shape=(H, W))
    got = tse.esl_disparity_search(tcam[r0:r1, c0:c1], None, emit_crop=True,
                                   prep=box_prep, **pk)
    jbox = np.asarray(jpe.esl_disparity_search(cam[r0:r1, c0:c1], proj[r0:r1, c0:c1],
                                               interpret=True, emit_crop=True, **pk))
    np.testing.assert_array_equal(got.numpy(), jbox)
    np.testing.assert_array_equal(got.numpy(), want[r0:r1, c0:c1])


def test_search_empty_footprint():
    cam = torch.zeros((16, 256))
    proj = torch.zeros((16, 256))
    kw = dict(row_range=(0, 0), col_range=(0, 0))
    out = tse.esl_disparity_search(cam, proj, **kw)
    want = np.asarray(jpe.esl_disparity_search(cam.numpy(), proj.numpy(), interpret=True, **kw))
    np.testing.assert_array_equal(out.numpy(), want)
    assert out.shape == (16, 256) and not out.any()
    assert tse.esl_search_prep(proj, **kw) is None
    crop = tse.esl_disparity_search(cam, proj, emit_crop=True, **kw)
    jcrop = jpe.esl_disparity_search(cam.numpy(), proj.numpy(), interpret=True,
                                     emit_crop=True, **kw)
    assert tuple(crop.shape) == jcrop.shape == (0, 256)


def test_rows_monotone_matches_jax():
    rng = np.random.default_rng(3)
    proj = np.zeros((4, 64), np.float32)
    proj[0, 10] = 0.5
    proj[0, 20] = 0.7
    assert tse.rows_monotone(proj)
    proj[0, 30] = 0.6  # decreasing nonzero
    assert not tse.rows_monotone(proj)
    for p in (proj, -np.abs(proj), np.sort(rng.random((5, 40)), 1),
              rng.random((5, 40)).astype(np.float32)):
        assert tse.rows_monotone(p) == jpe.rows_monotone(p)


# -- the per-scan device depth init on the synthetic rig ---------------------

RIG = dict(camera_width=64, camera_height=48, projector_width=90,
           projector_height=160, rectification_scale=3.0)
VARIANTS = {"xla_gather": (False, "auto"), "banded": (True, "auto"),
            "composed": (False, "composed")}


@pytest.fixture(scope="module")
def rig():
    jmaps = JMaps(make_synthetic_calibration(**RIG), zero_undistort_proj_map=True)
    tcal = t_calib(**RIG)
    tmaps = TMaps(tcal, zero_undistort_proj_map=True)
    proj_rect = tmaps.build_rectified_time_map(scan_upwards=False, border_replicate=False)
    np.testing.assert_array_equal(
        proj_rect, jmaps.build_rectified_time_map(scan_upwards=False, border_replicate=False))
    assert tse.rows_monotone(proj_rect)
    p03 = float(tmaps.P2[0, 3])
    rng = np.random.default_rng(7)
    cam = np.where(rng.random((48, 64)) < 0.8, rng.random((48, 64)), 0).astype(np.float32)
    # JAX side once per module: its three variants (interpret mode)
    jax_out = {}
    for name, (allow_banded, method) in VARIANTS.items():
        fn = jesl.build_device_depth_init(
            jmaps, jmaps.calib, proj_rect, p03, interpret=True,
            allow_banded=allow_banded, remap_method=method,
        )
        jax_out[name] = tuple(np.asarray(a) for a in fn(cam))
    return tcal, tmaps, proj_rect, p03, cam, jax_out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_device_depth_init_matches_jax(rig, variant):
    tcal, tmaps, proj_rect, p03, cam, jax_out = rig
    fn = tesl.build_device_depth_init(tmaps, tcal, proj_rect, p03, "cpu")
    disp, depth = fn(torch.from_numpy(cam))
    jdisp, jdepth = jax_out[variant]
    np.testing.assert_array_equal(disp.numpy(), jdisp)
    np.testing.assert_array_equal(depth.numpy(), jdepth)
    assert disp.any()
    # the brute-force oracle path of the port's app
    odisp, odepth = tesl.depth_init_dense(cam, tmaps, proj_rect, p03, "cpu")
    np.testing.assert_array_equal(disp.numpy(), odisp)
    np.testing.assert_array_equal(depth.numpy(), odepth)


def test_search_kernel_wrapper_refuses_other_devices(rig):
    cam = torch.zeros((8, 8), device="meta")
    tables = tuple(torch.zeros((8, 128), device="meta") for _ in range(5))
    with pytest.raises(ValueError, match="unsupported device"):
        tse.esl_search_box(cam, tables, w_clip=8, min_disp=5, max_disp=900, steps=11)


# -- the table reads that kernel A's bound counts (chip_smoke) ---------------

def _brute_force_table_reads(cam, tables, *, w_clip, min_disp, max_disp, steps):
    """The distinct (row, column) elements of each table that the search
    reads, pixel by pixel: the binary search's midpoints and its two
    candidates with their counts."""
    G = tables[0].numpy()
    last = G.shape[1] - 1
    reads = {k: set() for k in "GFNRC"}
    for r, c in zip(*np.nonzero(cam)):
        lo, hi = c + min_disp, min(c + max_disp, w_clip)
        left, right = lo, hi
        for _ in range(steps):
            m = min((left + right) // 2, last)
            reads["G"].add((r, m))
            if G[r, m] >= cam[r, c]:
                right = m
            else:
                left = m + 1
        j0 = min(right, hi)
        j0c, j0m1 = min(j0, last), min(max(j0 - 1, 0), last)
        reads["G"].add((r, j0c))
        reads["N"] |= {(r, j0c), (r, min(lo, last))}
        reads["F"].add((r, j0m1))
        reads["R"].add((r, j0m1))
        reads["C"] |= {(r, min(max(lo - 1, 0), last)), (r, j0m1),
                       (r, min(max(hi - 1, 0), last))}
    return {k: len(v) for k, v in reads.items()}


@pytest.mark.parametrize("case", ["frame_edge", "padded_clip"])
def test_esl_table_elements_match_brute_force(case):
    """``chip_smoke.esl_table_elements`` on a small random monotone box:
    the full frame (windows clip at its edge), and a box whose windows
    clip inside the 128-column padding."""
    from chip_smoke import esl_table_elements

    rng = np.random.default_rng(300 + len(case))
    H, W, max_disp = (10, 260, 120) if case == "frame_edge" else (14, 300, 200)
    base = np.sort(rng.random((H, W)).astype(np.float32), axis=1)
    proj = np.where(rng.random((H, W)) < 0.25, base + 1e-3, 0).astype(np.float32)
    cam = np.where(rng.random((H, W)) < 0.3, rng.random((H, W)), 0).astype(np.float32)
    assert tse.rows_monotone(proj)
    tables = tse.esl_search_prep(torch.from_numpy(proj), max_disp=max_disp)
    frame_w = W if case == "frame_edge" else 4 * W
    search = tse.box_search_args(frame_w, 0, W, max_disp=max_disp)
    assert search["w_clip"] == (W if case == "frame_edge" else 384)
    got = esl_table_elements(torch.from_numpy(cam), tables, **search)
    want = _brute_force_table_reads(cam, tables, **search)
    assert got == want
    assert all(v > 0 for v in got.values())
