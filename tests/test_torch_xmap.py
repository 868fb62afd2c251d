"""X-map build of the port vs the JAX package.

``xmaps_tpu_torch.ops.xmap.build_x_map`` (torch float32) must equal the JAX
float32 build bit for bit; the float64 NumPy build is the oracle both are
held to, up to the near-tie flips ``tests/test_ops.py`` allows the JAX
build.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xmaps_tpu.calib.maps import CamProjMaps  # noqa: E402
from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.models.depth_pipeline import _xmap_cache_key  # noqa: E402
from xmaps_tpu.ops.xmap import build_x_map as j_build  # noqa: E402
from xmaps_tpu.ops.xmap import build_x_map_numpy  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration  # noqa: E402

from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine as TEngine  # noqa: E402
from xmaps_tpu_torch.ops.xmap import build_x_map as t_build  # noqa: E402
from xmaps_tpu_torch.ops.xmap import xmap_cache_key  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration as t_calib  # noqa: E402

torch.set_num_threads(1)

RIGS = {
    "default": {},
    "graft": dict(camera_width=128, camera_height=96, projector_width=180, projector_height=320),
}


def _kw(width):
    return dict(x_map_width=width, t_px_scale=width - 1, num_scanlines=width)


@pytest.mark.parametrize("border_replicate", [False, True], ids=["executed", "replicate"])
@pytest.mark.parametrize("rig", sorted(RIGS))
def test_build_x_map_bit_equal(rig, border_replicate):
    calib = make_synthetic_calibration(**RIGS[rig])
    tm = CamProjMaps(calib).build_rectified_time_map(border_replicate=border_replicate)
    kw = _kw(calib.projector_width)
    jx, jd = j_build(jnp.asarray(tm), **kw)
    tx, td = t_build(torch.from_numpy(tm), **kw)
    assert tx.dtype == torch.int16 and td.dtype == torch.float32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the float64 oracle: identical but for rare near-tie argmin flips
    nx, _ = build_x_map_numpy(tm, **kw)
    mismatch = tx.numpy() != nx
    assert mismatch.mean() < 2e-3
    if mismatch.any():
        diff = tx.numpy()[mismatch].astype(np.int32) - nx[mismatch].astype(np.int32)
        assert np.abs(diff).max() <= 2
    assert (tx.numpy() != 0).mean() > 0.3


@pytest.mark.parametrize("row_block", [1, 3, 8, 64])
def test_row_block_does_not_change_result(row_block):
    calib = make_synthetic_calibration()
    tm = CamProjMaps(calib).build_rectified_time_map()
    kw = _kw(calib.projector_width)
    jx, jd = j_build(jnp.asarray(tm), **kw)
    tx, td = t_build(torch.from_numpy(tm), row_block=row_block, **kw)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_first_minimum_on_ties():
    """Equal time-map entries (and equidistant ones) resolve to the first
    x, undefined (0) entries are skipped, and bin 0 stays undefined."""
    width = 11
    tm = np.zeros((4, 9), np.float32)
    tm[0] = [0, 0.3, 0.3, 0.3, 0.5, 0.5, 0, 0.9, 0.9]
    tm[1] = [0.25, 0.35, 0.25, 0.35, 0, 0, 0, 0, 0]  # 0.3 is equidistant
    tm[2] = np.linspace(0.0, 1.0, 9)
    kw = dict(x_map_width=width, t_px_scale=width - 1, num_scanlines=4)
    jx, jd = j_build(jnp.asarray(tm), **kw)
    tx, td = t_build(torch.from_numpy(tm), **kw)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (tx[:, 0] == 0).all() and (tx[3] == 0).all()


def test_cache_key_and_disk_cache_shared_with_jax(tmp_path):
    """The port keys its X-map cache like the JAX engine: a file the port
    writes is the one the JAX engine reads."""
    tm = np.random.default_rng(0).random((13, 17)).astype(np.float32)
    assert xmap_cache_key(tm, 90, 89, 90) == _xmap_cache_key(tm, 90, 89, 90)
    assert xmap_cache_key(tm, 90, 89, 90) != xmap_cache_key(tm, 90, 88, 90)

    kw = dict(event_capacity=1024, z_near=0.2, z_far=1.2, xmap_cache_dir=str(tmp_path))
    port = TEngine.from_calibration(t_calib(), device="cpu", **kw)
    files = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("xmap_"))
    assert len(files) == 1
    jeng = JEngine.from_calibration(
        make_synthetic_calibration(), use_pallas_tail=False, use_pallas_events=False, **kw
    )
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("xmap_")) == files
    np.testing.assert_array_equal(jeng.x_map_np, port.x_map_np)
    again = TEngine.from_calibration(t_calib(), device="cpu", **kw)  # cache hit
    np.testing.assert_array_equal(again.x_map_np, port.x_map_np)
