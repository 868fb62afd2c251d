"""Packed last-write-wins scatter of the port vs the JAX package.

``xmaps_tpu_torch.ops.scatter.scatter_disp_packed`` (int32 tensor of
uint32 words) against ``xmaps_tpu.ops.scatter.scatter_disp_packed(method=
"max")`` (uint32 map): the packed words are compared exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xmaps_tpu.ops import scatter as jsc  # noqa: E402
from xmaps_tpu_torch.ops import scatter as tsc  # noqa: E402

torch.set_num_threads(1)

H, W = 37, 53


def _events(seed, n=3000):
    """Many duplicate targets (a 37x53 map, 3000 lanes), some out of the
    map, negative disparities and disparities >= PACK."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(-4, H + 4, n).astype(np.int32)
    xs = rng.integers(-4, W + 4, n).astype(np.int32)
    disp = rng.integers(-3, 300, n).astype(np.float32)
    disp[rng.random(n) < 0.01] = tsc.PACK + 5
    inlier = rng.random(n) < 0.8
    return ys, xs, disp, inlier


def _both(ys, xs, disp, inlier, **kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "priority" in kw:
        jkw["priority"] = jnp.asarray(kw["priority"])
        tkw["priority"] = torch.from_numpy(kw["priority"])
    ref = jsc.scatter_disp_packed(
        jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(disp), jnp.asarray(inlier),
        method="max", **jkw,
    )
    got = tsc.scatter_disp_packed(
        torch.from_numpy(ys), torch.from_numpy(xs), torch.from_numpy(disp),
        torch.from_numpy(inlier), **tkw,
    )
    assert got.dtype == torch.int32
    return got, np.asarray(ref)


@pytest.mark.parametrize(
    "case",
    ["plain", "index_offset", "priority", "window", "pad_shape", "window_pad"],
)
def test_scatter_matches_jax(case):
    ys, xs, disp, inlier = _events(sum(map(ord, case)))
    kw = dict(height=H, width=W)
    if case == "index_offset":
        kw["index_offset"] = 70000
    elif case == "priority":
        kw["priority"] = np.random.default_rng(1).permutation(len(ys)).astype(np.int32)
    elif case == "window":
        kw["window"] = (5, 7, 20, 31)
    elif case == "pad_shape":
        kw["pad_shape"] = (40, 64)
    elif case == "window_pad":
        kw["window"] = (5, 7, 20, 31)
        kw["pad_shape"] = (24, 32)
    got, ref = _both(ys, xs, disp, inlier, **kw)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), ref.astype(np.int64))
    # duplicates really were resolved: fewer written pixels than kept lanes
    assert 0 < (ref > 0).sum() < inlier.sum()
    np.testing.assert_array_equal(
        tsc.unpack_disp(got).numpy(), np.asarray(jsc.unpack_disp(jnp.asarray(ref)))
    )


def test_last_write_wins():
    """The highest priority among lanes on one pixel wins, as NumPy's
    fancy-indexing assignment does."""
    ys = np.array([1, 1, 1, 2], np.int32)
    xs = np.array([3, 3, 3, 0], np.int32)
    disp = np.array([7, 9, 4, 1], np.float32)
    inlier = np.array([True, True, True, True])
    got, ref = _both(ys, xs, disp, inlier, height=4, width=5)
    ref_np = np.zeros((4, 5), np.float32)
    ref_np[ys, xs] = disp
    np.testing.assert_array_equal(tsc.unpack_disp(got).numpy(), ref_np)
    assert int(got[1, 3]) == 3 * tsc.PACK + 4


def test_overflow_assertion():
    """(capacity + index_offset + 1) * PACK must stay below 2**32, as the
    JAX package's uint32 packing; keys above 2**31 are kept bit for bit."""
    ys, xs, disp, inlier = _events(2, n=4)
    inlier[:] = True
    ys[:], xs[:] = 3, 5  # one pixel: the last lane wins
    disp[:] = 7
    t = [torch.from_numpy(a) for a in (ys, xs, disp, inlier)]
    kw = dict(height=H, width=W)
    off = 2**32 // tsc.PACK - 6
    got = tsc.scatter_disp_packed(*t, index_offset=off, **kw)
    assert int(got.numpy().view(np.uint32)[3, 5]) == (off + 4) * tsc.PACK + 7
    ref = jsc.scatter_disp_packed(*(jnp.asarray(a) for a in (ys, xs, disp, inlier)),
                                  index_offset=off, method="max", **kw)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(ref))
    assert tsc.unpack_disp(got)[3, 5] == 7
    with pytest.raises(AssertionError, match="overflows the uint32"):
        tsc.scatter_disp_packed(*t, index_offset=off + 1, **kw)
