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
