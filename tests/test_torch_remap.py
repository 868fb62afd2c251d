"""The port's static remap (kernel B's plain version) vs the JAX package.

``xmaps_tpu_torch.ops.remap`` against ``xmaps_tpu.ops.pallas_remap`` with
its Pallas kernels in interpret mode (the walk, the ``inb`` walk, the
composed two-gather variant, the HBM-banded variant) and against the NumPy
``remap_nearest`` of the calibration code, on the shapes of
``tests/test_pallas_esl.py``.  Every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmaps_tpu.calib.maps import remap_nearest  # noqa: E402
from xmaps_tpu.ops import pallas_remap as jr  # noqa: E402

from xmaps_tpu_torch.calib.maps import remap_nearest as t_remap_nearest  # noqa: E402
from xmaps_tpu_torch.ops import remap as tr  # noqa: E402

torch.set_num_threads(1)


def _smooth_maps(out_shape, src_shape, margin=2.0):
    """Smooth (rectification-like) float maps that overshoot the source,
    so out-of-range destinations exist (as tests/test_pallas_esl.py)."""
    H, W = out_shape
    Hs, Ws = src_shape
    jj, ii = np.meshgrid(np.arange(W), np.arange(H))
    map_x = (jj + 0.5) * (Ws + margin) / W - 1.0 + 0.8 * np.sin(ii / 17.0)
    map_y = (ii + 0.5) * (Hs + margin) / H - 1.0 + 0.8 * np.cos(jj / 23.0)
    return map_x.astype(np.float32), map_y.astype(np.float32)


def _rotated_maps(trial, out_shape):
    """Rotated upsampling maps that force the composed kernel's layers."""
    H, W = out_shape
    jj, ii = np.meshgrid(np.arange(W), np.arange(H))
    map_x = (jj * 0.33 + 0.05 * ii - 1.0).astype(np.float32)
    map_y = (ii * 0.28 + 0.09 * jj - 1.0).astype(np.float32)
    return map_x, map_y


CASES = {
    # name -> (src shape, out shape, maps)
    "random": ((48, 64), (120, 200), None),
    "smooth": ((40, 512), (96, 640), _smooth_maps),
    "rotated0": ((40, 200), (120, 300), _rotated_maps),
    "rotated2": ((56, 328), (120, 500), _rotated_maps),
}


def _case(name):
    (Hs, Ws), (H, W), fn = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    src = rng.random((Hs, Ws)).astype(np.float32)
    if fn is None:
        map_x = (rng.random((H, W)) * Ws * 1.2 - 4).astype(np.float32)
        map_y = (rng.random((H, W)) * Hs * 1.2 - 4).astype(np.float32)
    elif fn is _rotated_maps:
        map_x, map_y = fn(0, (H, W))
    else:
        map_x, map_y = fn((H, W), (Hs, Ws))
    return src, map_x, map_y, (H, W)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_remap_indices_equal(name):
    src, map_x, map_y, _ = _case(name)
    for a, b in zip(tr.build_remap_indices(map_x, map_y, src.shape),
                    jr.build_remap_indices(map_x, map_y, src.shape)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", ["walk", "inb_walk", "inb_composed"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_remap_static_matches_jax(name, route):
    src, map_x, map_y, out_shape = _case(name)
    yi, xi, inb = jr.build_remap_indices(map_x, map_y, src.shape)
    assert inb.any() and not inb.all()  # out-of-range lanes exist
    kw = {} if route == "walk" else dict(inb=inb)
    jkw = kw if route == "walk" else dict(kw, method=route.split("_")[1])
    want = np.asarray(jr.remap_static(src, yi, xi, out_shape, interpret=True, **jkw))
    got = tr.remap_static(torch.from_numpy(src), yi, xi, out_shape, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == out_shape
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = remap_nearest(src, map_x, map_y, border_replicate=False)
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(
        t_remap_nearest(src, map_x, map_y, border_replicate=False), oracle
    )


@pytest.mark.parametrize("trial", range(3))
def test_remap_banded_hbm_matches_jax(trial):
    rng = np.random.default_rng(trial)
    Hs, Ws = 8 * (20 + 4 * trial), 128 * (3 + trial)
    H, W = 56, 200 + 50 * trial
    src = rng.random((Hs, Ws)).astype(np.float32)
    map_x, map_y = _smooth_maps((H, W), (Hs, Ws))
    yi, xi, inb = jr.build_remap_indices(map_x, map_y, (Hs, Ws))
    assert inb.any() and not inb.all()
    want = np.asarray(jr.remap_banded_hbm(src, yi, xi, inb, (H, W), interpret=True))
    assert tr.banded_hbm_viable((Hs, Ws), yi, xi, inb, (H, W))
    got = tr.remap_banded_hbm(torch.from_numpy(src), yi, xi, inb, (H, W))
    np.testing.assert_array_equal(got.numpy(), want)


def test_prepare_apply_and_gather_contract():
    """prepare/apply equal remap_static; prepare packs one int32 flat index
    (-1 for a zero); the gather zeroes -1 and any index outside the
    source."""
    src, map_x, map_y, out_shape = _case("smooth")
    yi, xi, inb = tr.build_remap_indices(map_x, map_y, src.shape)
    cfg, arrs = tr.prepare_remap_static(yi, xi, inb, out_shape, src.shape)
    (idx,) = arrs
    assert idx.dtype == np.int32 and idx.shape == out_shape and idx.flags.c_contiguous
    np.testing.assert_array_equal(idx, tr.pack_remap_index(yi, xi, inb, src.shape))
    s = torch.from_numpy(src)
    got = tr.apply_remap_static(s, tr.upload(arrs, "cpu"), cfg)
    np.testing.assert_array_equal(got.numpy(), tr.remap_static(s, yi, xi, out_shape, inb=inb).numpy())
    Hs, Ws = src.shape
    flat = torch.tensor([[0, Hs * Ws - 1, -1, Hs * Ws, Ws + 3, -7]], dtype=torch.int32)
    out = tr.remap_gather(s, flat)
    np.testing.assert_array_equal(out.numpy(), [[src[0, 0], src[Hs - 1, Ws - 1], 0, 0, src[1, 3], 0]])
    with pytest.raises(ValueError, match="unsupported device"):
        tr.remap_gather(s.to("meta"), flat.to("meta"))
    with pytest.raises(ValueError, match="index maps"):
        tr.prepare_remap_static(yi, xi, inb, (out_shape[0] + 1, out_shape[1]), src.shape)


@pytest.mark.parametrize("with_inb", [False, True], ids=["no_inb", "inb"])
def test_pack_remap_index_out_of_range(with_inb):
    """Rows and columns outside the source (negative, == Hs / == Ws, the
    ``xi == Ws`` zero column) pack to -1, in range to ``yi * Ws + xi``;
    ``inb`` masks lanes that are in range."""
    Hs, Ws = 5, 7
    yi = np.array([[0, 4, -1, 5, 2, 2, 3, 4]])
    xi = np.array([[0, 6, 1, 1, -1, 7, 3, Ws]])
    inb = np.array([[True, True, True, True, True, True, False, True]])
    want_ok = [Ws * 0 + 0, 4 * Ws + 6, -1, -1, -1, -1, 3 * Ws + 3, -1]
    got = tr.pack_remap_index(yi, xi, inb if with_inb else None, (Hs, Ws))
    assert got.dtype == np.int32 and got.shape == yi.shape
    if with_inb:
        want_ok[6] = -1
    np.testing.assert_array_equal(got, [want_ok])
    # build_remap_indices' own sentinel: xi == Ws where out of range
    rng = np.random.default_rng(1)
    mx = (rng.random((9, 11)) * Ws * 1.6 - 3).astype(np.float32)
    my = (rng.random((9, 11)) * Hs * 1.6 - 3).astype(np.float32)
    byi, bxi, binb = tr.build_remap_indices(mx, my, (Hs, Ws))
    idx = tr.pack_remap_index(byi, bxi, binb if with_inb else None, (Hs, Ws))
    np.testing.assert_array_equal(idx >= 0, binb)
    np.testing.assert_array_equal(idx[binb], (byi * Ws + bxi)[binb])


def test_pack_remap_index_refuses_large_sources():
    yi = xi = np.zeros((2, 2), np.int32)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tr.pack_remap_index(yi, xi, None, (2**16, 2**15))
    assert tr.pack_remap_index(yi, xi, None, (2**16, 2**15 - 1)).tolist() == [[0, 0], [0, 0]]


@pytest.mark.parametrize("with_inb", [False, True], ids=["no_inb", "inb"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_plain_packed_matches_jax(name, with_inb):
    """Kernel B's plain version through the packed index equals the JAX
    package's ``remap_static`` (Pallas walk in interpret mode)."""
    src, map_x, map_y, out_shape = _case(name)
    yi, xi, inb = jr.build_remap_indices(map_x, map_y, src.shape)
    kw = dict(inb=inb) if with_inb else {}
    want = np.asarray(jr.remap_static(src, yi, xi, out_shape, interpret=True, **kw))
    idx = tr.pack_remap_index(yi, xi, inb if with_inb else None, src.shape)
    got = tr.remap_gather_plain(torch.from_numpy(src), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == out_shape
    np.testing.assert_array_equal(got.numpy(), want)
