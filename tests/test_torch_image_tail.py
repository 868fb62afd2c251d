"""Dense image tail of the port vs the JAX package.

Each function of ``xmaps_tpu_torch.ops.image_tail`` against its
``xmaps_tpu.ops.image_tail`` counterpart on the same numpy inputs; every
output, the float32 depth included, is compared exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xmaps_tpu.ops import image_tail as jit_  # noqa: E402
from xmaps_tpu_torch.ops import image_tail as tit  # noqa: E402

torch.set_num_threads(1)

Z_NEAR, Z_FAR = 0.2, 1.2


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(40, 57), (7, 7), (3, 90)])
def test_dilate_max(shape):
    """Sparse non-negative maps (the engine's case) and signed values,
    which only agree if both pad with -inf."""
    rng = np.random.default_rng(shape[0] * shape[1])
    img = np.zeros(shape, np.float32)
    m = rng.random(shape) < 0.05
    img[m] = rng.integers(1, 400, m.sum())
    signed = rng.normal(size=shape).astype(np.float32) - 3.0
    for a in (img, signed):
        _eq(tit.dilate_max(torch.from_numpy(a), 7), jit_.dilate_max(jnp.asarray(a), 7))


def test_remap_nearest_i16_border_constant():
    rng = np.random.default_rng(4)
    img = rng.random((30, 44)).astype(np.float32) + 1.0
    mapx = rng.integers(-6, 50, (25, 19)).astype(np.int16)
    mapy = rng.integers(-6, 36, (25, 19)).astype(np.int16)
    got = tit.remap_nearest_i16(torch.from_numpy(img), torch.from_numpy(mapx), torch.from_numpy(mapy))
    _eq(got, jit_.remap_nearest_i16(jnp.asarray(img), jnp.asarray(mapx), jnp.asarray(mapy)))
    assert (got == 0).any() and (got > 0).any()


def test_disparity_to_depth():
    disp = np.concatenate([
        np.zeros(5), np.arange(1, 6000), [0.5, 1e-30, 8191.0],
    ]).astype(np.float32)
    for p03 in (130.30606, 177.95787, 1e-3):
        p = np.float32(p03)
        got = tit.disparity_to_depth(torch.from_numpy(disp), torch.tensor(p))
        assert got.dtype == torch.float32
        _eq(got, jit_.disparity_to_depth(jnp.asarray(disp), jnp.asarray(p)))


def test_clip_normalize_u8_edges():
    """Depths at z_near and z_far exactly (255.0 exactly), outside the
    range, 0 (undefined) and a dense sweep across every u8 bin."""
    zn, zf = np.float32(Z_NEAR), np.float32(Z_FAR)
    depth = np.concatenate([
        [0.0, zn, zf, np.nextafter(zf, np.float32(0)), np.nextafter(zf, np.float32(9)),
         -1.0, 1e-9, 50.0, np.inf],
        np.linspace(0.0, 1.5, 20001),
    ]).astype(np.float32)
    got = tit.clip_normalize_u8(torch.from_numpy(depth), Z_NEAR, Z_FAR)
    assert got.dtype == torch.uint8
    _eq(got, jit_.clip_normalize_u8(jnp.asarray(depth), Z_NEAR, Z_FAR))
    assert int(got[2]) == 255 and int(got[0]) == 0 and int(got[1]) == 0
    assert int(got[7]) == 255  # clipped to z_far


def test_colorize_turbo_every_bin():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = tit.colorize_turbo(torch.from_numpy(u8))
    assert got.dtype == torch.uint8 and got.shape == (16, 16, 3)
    _eq(got, jit_.colorize_turbo(jnp.asarray(u8)))
    packed = tit.colorize_turbo_packed(torch.from_numpy(u8))
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(
        packed.numpy().astype(np.int64),
        np.asarray(jit_.colorize_turbo_packed(jnp.asarray(u8))).astype(np.int64),
    )
    # the packed word carries the same three bytes
    np.testing.assert_array_equal(
        packed.numpy().view(np.uint8).reshape(16, 16, 4)[..., :3], got.numpy()
    )
