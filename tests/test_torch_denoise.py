"""The port's eval filters (``xmaps_tpu_torch.utils.denoise``'s median, the
plain versions of ESL's denoise in ``xmaps_tpu_torch.ops.esl_denoise``) vs
the JAX package's (``xmaps_tpu.utils.denoise``), on the same seeded inputs.

- ``median_blur_3x3``: exact.
- ``bilateral_filter``: relative tolerance 1e-5.  ``exp`` differs between
  the libraries and XLA on the CPU contracts the weight sums into FMAs, so
  about 40% of the pixels differ, by at most ~2e-6 relative (31 ulp).
- ``tv_denoise_split_bregman``: absolute tolerance 1e-4 on depths in
  [0, 50] (2e-6 of the range).  No transcendental, but XLA's FMA
  contraction over 20 x 10 Jacobi sweeps leaves about 65% of the pixels a
  few ulp to ~1e-5 apart.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmaps_tpu.utils import denoise as jd  # noqa: E402

from xmaps_tpu_torch.ops import esl_denoise as ed  # noqa: E402
from xmaps_tpu_torch.utils import denoise as td  # noqa: E402

torch.set_num_threads(1)


def _depth(seed, shape=(60, 80), holes=0.3):
    """A sparse depth-like map: values in [10, 50], zeros where undefined."""
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) * 40 + 10).astype(np.float32)
    img[rng.random(shape) < holes] = 0
    return img


@pytest.mark.parametrize("case", ["depth", "ties", "edges"])
def test_median_blur_bit_equal(case):
    rng = np.random.default_rng(len(case))
    if case == "depth":
        img = _depth(1)
    elif case == "ties":
        img = rng.integers(0, 4, (33, 47)).astype(np.float32)  # many equal values
    else:
        img = rng.random((3, 5)).astype(np.float32)  # every pixel at the border
    want = np.asarray(jd.median_blur_3x3(img))
    got = td.median_blur_3x3(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)
    # NumPy input goes to the CPU, as eval_metrics.combine_depths passes it
    np.testing.assert_array_equal(np.asarray(td.median_blur_3x3(img)), want)


@pytest.mark.parametrize("shape", [(60, 80), (33, 21)])
def test_bilateral_within_tolerance(shape):
    img = _depth(2, shape)
    want = np.asarray(jd.bilateral_filter(img, d=5, sigma_color=3.0, sigma_space=3.0))
    got = ed.bilateral_filter(torch.from_numpy(img), d=5, sigma_color=3.0, sigma_space=3.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("seed", [3, 4])
def test_tv_denoise_within_tolerance(seed):
    img = _depth(seed)
    want = np.asarray(jd.tv_denoise_split_bregman(img, mu=0.5))
    got = ed.tv_denoise_split_bregman(torch.from_numpy(img), mu=0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the filter really smooths: not a copy of its input
    assert np.abs(want - img).max() > 1.0
