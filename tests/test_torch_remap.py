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
    if route == "walk":
        kw = {}
    else:
        kw = dict(inb=inb, method=route.split("_")[1])
    want = np.asarray(jr.remap_static(src, yi, xi, out_shape, interpret=True, **kw))
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
    """prepare/apply equal remap_static; the gather zeroes masked lanes,
    ``xi == Ws`` and any out-of-range index."""
    src, map_x, map_y, out_shape = _case("smooth")
    yi, xi, inb = tr.build_remap_indices(map_x, map_y, src.shape)
    cfg, arrs = tr.prepare_remap_static(yi, xi, inb, out_shape, src.shape[1])
    s = torch.from_numpy(src)
    got = tr.apply_remap_static(s, tr.upload(arrs, "cpu"), cfg)
    np.testing.assert_array_equal(got.numpy(), tr.remap_static(s, yi, xi, out_shape, inb=inb).numpy())
    Hs, Ws = src.shape
    y = torch.tensor([[0, Hs - 1, -1, Hs, 3, 3]], dtype=torch.int32)
    x = torch.tensor([[Ws - 1, 0, 2, 2, Ws, -1]], dtype=torch.int32)
    out = tr.remap_gather(s, y, x)
    np.testing.assert_array_equal(out.numpy(), [[src[0, Ws - 1], src[Hs - 1, 0], 0, 0, 0, 0]])
    mask = torch.tensor([[False, True, True, True, True, True]])
    assert float(tr.remap_gather(s, y, x, mask)[0, 0]) == 0.0
    with pytest.raises(ValueError, match="unknown remap method"):
        tr.remap_static(s, yi, xi, out_shape, method="banded")
    with pytest.raises(ValueError, match="unsupported device"):
        tr.remap_gather(s.to("meta"), y.to("meta"), x.to("meta"))
