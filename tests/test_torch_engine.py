"""The port's engine (``xmaps_tpu_torch``) vs the JAX engine, end to end.

Both engines are built from the same synthetic calibration and fed the
same events.  The port runs on ``device="cpu"`` (the kernels' plain
versions); the JAX side runs its XLA chain and, at the default rig, its
Pallas kernels in interpret mode.  ``frame_bgr``, ``disp_map``, ``depth``
and ``num_inliers`` are compared exactly in both views.  The last tests
pin what the port must not do: import JAX, or pick or fall back to a
device on its own.
"""

import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import oracle  # noqa: E402
from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.ops.event_batch import EventBatch as JBatch  # noqa: E402
from xmaps_tpu.ops.frame_pipeline import depth_frame as j_depth_frame  # noqa: E402
from xmaps_tpu.ops.pallas_events import build_event_gather_plan  # noqa: E402
from xmaps_tpu.ops.pallas_tail import build_cam_tail_plan, build_tail_plan  # noqa: E402
from xmaps_tpu.utils.synthetic import (  # noqa: E402
    make_synthetic_calibration,
    simulate_plane_events,
)

import xmaps_tpu_torch  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine as TEngine  # noqa: E402
from xmaps_tpu_torch.ops import _build  # noqa: E402
from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter  # noqa: E402
from xmaps_tpu_torch.ops.cuda_tail import colorize_camera, tail_projector  # noqa: E402
from xmaps_tpu_torch.ops.frame_pipeline import DeviceTables, depth_frame  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import (  # noqa: E402
    make_synthetic_calibration as t_calib,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
Z_NEAR, Z_FAR = 0.2, 1.2
#: rig name -> (calibration sizes, event capacity, subsample of the three
#: plane frames: about 1/3 and 2/3 of capacity, then over it)
RIGS = {
    "default": ({}, 2048, (0.05, 0.1, 0.2)),
    "graft": (dict(camera_width=128, camera_height=96, projector_width=180,
                   projector_height=320), 4096, (0.025, 0.05, 0.1)),
}
VIEWS = {"projector": False, "camera": True}


@functools.lru_cache(maxsize=None)
def _engines(rig, camera_perspective):
    sizes, capacity, _ = RIGS[rig]
    kw = dict(event_capacity=capacity, z_near=Z_NEAR, z_far=Z_FAR,
              camera_perspective=camera_perspective)
    jeng = JEngine.from_calibration(
        make_synthetic_calibration(**sizes),
        use_pallas_tail=False, use_pallas_events=False, **kw,
    )
    teng = TEngine.from_calibration(t_calib(**sizes), device="cpu", **kw)
    return jeng, teng


@functools.lru_cache(maxsize=None)
def _frames(rig):
    """Three plane frames (the last over capacity, so it is truncated),
    plus an empty frame."""
    sizes, _, subsamples = RIGS[rig]
    calib = make_synthetic_calibration(**sizes)
    rng = np.random.default_rng(7)
    frames = [
        simulate_plane_events(calib, depth_m=d, subsample=s, jitter_us=2.0, rng=rng)
        for d, s in zip((0.45, 0.6, 0.75), subsamples)
    ]
    return frames + [frames[0][:0]]


def _assert_same(got, ref, packed=False):
    frame = got.frame_bgr.numpy()
    rframe = np.asarray(ref.frame_bgr)
    if packed:
        assert got.frame_bgr.dtype == torch.int32
        frame, rframe = frame.astype(np.int64), rframe.astype(np.int64)
    np.testing.assert_array_equal(frame, rframe)
    for name in ("depth", "disp_map"):
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got.num_inliers) == int(ref.num_inliers)


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("rig", sorted(RIGS))
def test_tables_match_jax(rig, view):
    """The port's own init (its calibration copy, the torch X-map build,
    the packed LUT) reproduces the JAX engine's device tables."""
    jeng, teng = _engines(rig, VIEWS[view])
    np.testing.assert_array_equal(teng.x_map_np, jeng.x_map_np)
    np.testing.assert_array_equal(teng.time_map_rect, jeng.time_map_rect)
    for name in jeng.tables._fields:
        np.testing.assert_array_equal(
            getattr(teng.tables, name).numpy(), np.asarray(getattr(jeng.tables, name)), err_msg=name
        )


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("rig", sorted(RIGS))
def test_process_frame_matches_jax(rig, view):
    jeng, teng = _engines(rig, VIEWS[view])
    for ev in _frames(rig):
        got = teng.process_frame(ev)
        _assert_same(got, jeng.process_frame(ev))
        assert got.frame_bgr.device.type == "cpu"
    assert int(teng.process_frame(_frames(rig)[1]).num_inliers) > 500


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_display_variants_match_jax(view):
    jeng, teng = _engines("graft", VIEWS[view])
    ev = _frames("graft")[1]
    jb = jeng.make_batch(ev)
    for packed in (False, True):
        fn = jax.jit(functools.partial(
            j_depth_frame, cfg=jeng.cfg, display_only=True, display_packed=packed
        ))
        got = teng.process_frame(ev, display_only=True, display_packed=packed)
        _assert_same(got, fn(jb, jeng.tables), packed=packed)
    with pytest.raises(ValueError, match="requires display_only"):
        teng.process_frame(ev, display_packed=True)


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_process_frame_matches_pallas_interpret(view):
    """The JAX engine's accelerator path: the event-gather kernel and the
    projector tail / camera colorize kernels, in interpret mode."""
    jeng, teng = _engines("default", VIEWS[view])
    cfg, maps = jeng.cfg, jeng.maps
    p03 = float(maps.P2[0, 3])
    if VIEWS[view]:
        tail_plan = build_cam_tail_plan(cfg.camera_height, cfg.camera_width, p03, Z_NEAR, Z_FAR)
    else:
        tail_plan = build_tail_plan(
            maps.disp_proj_mapx_i16, maps.disp_proj_mapy_i16,
            cfg.rect_height, cfg.rect_width, p03=p03, z_near=Z_NEAR, z_far=Z_FAR,
        )
    event_plan = build_event_gather_plan(np.asarray(jeng.tables.cam_map_packed), jeng.x_map_np)
    ev = _frames("default")[1]
    ref = j_depth_frame(
        jeng.make_batch(ev), jeng.tables, cfg,
        tail_plan=tail_plan, event_plan=event_plan, pallas_interpret=True,
    )
    _assert_same(teng.process_frame(ev), ref)


def test_projector_view_matches_oracle():
    """The NumPy transcription of the reference's per-frame path
    (tests/oracle.py), on a frame within capacity."""
    jeng, teng = _engines("graft", False)
    ev = _frames("graft")[0]
    assert len(ev) < teng.cfg.event_capacity
    cfg = teng.cfg
    ref = oracle.oracle_frame_projector_view(
        ev, jeng.maps, teng.x_map_np, t_px_scale=cfg.t_px_scale, z_near=Z_NEAR,
        z_far=Z_FAR, H_proj=cfg.projector_height, W_proj=cfg.projector_width,
    )
    got = teng.process_frame(ev)
    np.testing.assert_array_equal(got.disp_map.numpy(), ref["disp_proj"])
    np.testing.assert_array_equal(got.depth.numpy(), ref["depth"])
    np.testing.assert_array_equal(got.frame_bgr.numpy(), ref["bgr"])
    assert int(got.num_inliers) == int(ref["inlier"].sum())


def test_process_frames_matches_jax():
    jeng, teng = _engines("default", False)
    frames = _frames("default")
    got = teng.process_frames(frames)
    ref = jeng.process_frames(frames)
    assert len(got) == len(ref) == len(frames)
    for g, r in zip(got, ref):
        _assert_same(g, r)
    packed = teng.process_frames(frames, display_only=True, display_packed=True)
    for g, ev in zip(packed, frames):
        assert torch.equal(
            g.frame_bgr, teng.process_frame(ev, display_only=True, display_packed=True).frame_bgr
        )
    assert teng.process_frames([]) == []


def test_same_tables_through_from_numpy():
    """``DeviceTables.from_numpy`` takes the JAX package's tables as numpy;
    the port's depth_frame on them equals the JAX frame."""
    jeng, teng = _engines("graft", False)
    jt = jeng.tables
    tables = DeviceTables.from_numpy(
        *(np.asarray(a) for a in (jt.cam_mapx_i16, jt.cam_mapy_i16, jt.x_map,
                                  jt.proj_mapx_i16, jt.proj_mapy_i16, jt.p03)),
        device="cpu",
    )
    ev = _frames("graft")[2]
    got = depth_frame(teng.make_batch(ev), tables, teng.cfg, teng.plan)
    _assert_same(got, j_depth_frame(JBatch.from_structured(ev, jeng.cfg.event_capacity), jt, jeng.cfg))


def test_set_frame_filter_only_none():
    """Every dedup filter of the JAX package is selectable (and back to
    "none"); an unknown name raises ValueError, as the JAX filters do, and
    leaves the filter as it was.  tests/test_torch_filters.py holds the
    filtered frames against the JAX engine.  (The name is the one the test
    had while the port refused every filter but "none"; it is kept so that
    the test's history stays one test.)"""
    from xmaps_tpu.ops.filters import FILTER_NAMES as J_FILTER_NAMES

    _, teng = _engines("default", False)
    ev = _frames("default")[1]
    try:
        inliers = {}
        for name in J_FILTER_NAMES:
            teng.set_frame_filter(name)
            assert teng.cfg.frame_filter == name
            inliers[name] = int(teng.process_frame(ev).num_inliers)
        for name in ("dedup_xy", "raster_first"):
            with pytest.raises(ValueError, match="unknown frame filter"):
                teng.set_frame_filter(name)
            assert teng.cfg.frame_filter == J_FILTER_NAMES[-1]
    finally:
        teng.set_frame_filter("none")
    assert teng.cfg.frame_filter == "none"
    # the polarity drop and the dedup leave fewer inliers than no filter
    assert all(0 < inliers[n] <= inliers["none"] for n in J_FILTER_NAMES)


def test_capacity_overflow_refused():
    """The uint32 packing holds capacities up to 524286, as in the JAX
    package; one more is refused."""
    with pytest.raises(ValueError, match="524286"):
        TEngine.from_calibration(t_calib(), device="cpu", event_capacity=524287)


# -- no hidden device, no JAX ---------------------------------------------


def test_cuda_device_refused_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TEngine.from_calibration(t_calib(), device="cuda", event_capacity=1024)
    with pytest.raises(ValueError, match="unsupported device"):
        TEngine.from_calibration(t_calib(), device="meta", event_capacity=1024)
    _, teng = _engines("default", False)
    with pytest.raises(RuntimeError, match="is_available"):
        teng.to("cuda")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("XMAPS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on CUDA is refused, not run by a
    plain version."""
    _, teng = _engines("default", False)
    meta = torch.zeros((teng.plan.H, teng.plan.W), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tail_projector(meta, teng.tables, teng.plan)
    with pytest.raises(ValueError, match="unsupported device"):
        colorize_camera(meta, teng.tables, teng.plan)
    batch = teng.make_batch(_frames("default")[0])
    mbatch = type(batch)(*(a.to("meta") for a in batch))
    with pytest.raises(ValueError, match="unsupported device"):
        event_disparity_scatter(
            mbatch, mbatch.t, teng.tables, camera_view=False, window=(0, 0), out_shape=(4, 4)
        )


def test_package_source_imports_no_jax():
    """No module of the port imports jax or the JAX package, at any depth
    of its own source."""
    pkg = Path(xmaps_tpu_torch.__file__).parent
    bad = []
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "xmaps_tpu")]
    assert not bad, bad


def test_cpu_frame_in_subprocess_never_loads_jax():
    code = """
import sys
import numpy as np
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration, simulate_plane_events
import torch
torch.set_num_threads(1)
calib = make_synthetic_calibration()
eng = XMapsDepthEngine.from_calibration(
    calib, device="cpu", event_capacity=2048, z_near=0.2, z_far=1.2)
out = eng.process_frame(
    simulate_plane_events(calib, depth_m=0.6, rng=np.random.default_rng(0)))
assert out.frame_bgr.shape == (160, 90, 3), out.frame_bgr.shape
assert int(out.num_inliers) > 500
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "xmaps_tpu"))
assert not loaded, loaded
print("no-jax-ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout
