"""The port's geometry bench (``xmaps_tpu_torch.apps.bench_geometry``)
against the JAX package's script (``eval/bench_geometry.py``).

The rigs and the frames are compared with the JAX script's, restated here
on ``xmaps_tpu.utils.synthetic`` (the script builds them inside its
``main``); the bench's frames run through the port's ``process_frames``
and the JAX engine's (its XLA chain, no Pallas) on the CPU, exactly; the
app runs on the CPU at the demonstrator rig with 2 small frames.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration  # noqa: E402
from xmaps_tpu.utils.synthetic import simulate_plane_events  # noqa: E402

from xmaps_tpu_torch.apps import bench_geometry  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine as TEngine  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
VIEWS = {"projector": False, "camera": True}
#: the app's small CPU run: 2 demonstrator frames of 3072 events
SMALL = ["--device", "cpu", "--geometry", "demo", "--frames", "2", "--events", "4096",
         "--rounds", "1", "3"]


def _jax_rig(geometry):
    """The JAX script's calibration (``eval/bench_geometry.py:72-109``)."""
    if geometry == "esl":
        calib = make_synthetic_calibration(
            camera_width=640, camera_height=480, projector_width=1080, projector_height=1920)
        return dataclasses.replace(calib, rect_image_width=3 * 1080,
                                   rect_image_height=3 * 1920)
    return make_synthetic_calibration(
        camera_width=640, camera_height=480, projector_width=720, projector_height=1280)


def _jax_frames(calib, n, events):
    """The JAX script's frame loop (``eval/bench_geometry.py:111-126``)."""
    rng = np.random.default_rng(7)
    frames = []
    target = events - 1024
    for i in range(n):
        ev = simulate_plane_events(calib, depth_m=0.45 + 0.02 * i, subsample=0.031,
                                   jitter_us=2.0, rng=rng)
        if len(ev) > target:
            keep = np.sort(rng.choice(len(ev), size=target, replace=False))
            ev = ev[keep]
        frames.append(ev)
    return frames


@pytest.mark.parametrize("geometry", ["esl", "demo"])
def test_rig_equals_the_jax_scripts(geometry):
    """Every field of ``rig`` equal to the JAX script's calibration; the
    ESL rig's rectified frame is 3x the projector."""
    got, want = bench_geometry.rig(geometry), _jax_rig(geometry)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert type(a) is type(b), f.name
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    sizes = (got.camera_width, got.camera_height, got.projector_width, got.projector_height,
             got.rect_image_height, got.rect_image_width)
    assert sizes == {"esl": (640, 480, 1080, 1920, 5760, 3240),
                     "demo": (640, 480, 720, 1280, 1320, 1760)}[geometry]
    with pytest.raises(ValueError, match="geometry"):
        bench_geometry.rig("paper")


@pytest.mark.parametrize("geometry", ["esl", "demo"])
def test_make_frames_equals_the_jax_loop(geometry):
    """All 12 frames at the default 28672 events, field by field: the
    generator's draws line up frame after frame (every frame here is over
    the target and cut to it)."""
    calib = _jax_rig(geometry)
    got = bench_geometry.make_frames(bench_geometry.rig(geometry), 12, 28 * 1024)
    want = _jax_frames(calib, 12, 28 * 1024)
    assert len(got) == len(want) == 12
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and len(a) == len(b) == 28 * 1024 - 1024, i
        for name in b.dtype.names:
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"frame {i} {name}")


def test_make_frames_keeps_a_frame_under_the_target():
    """A frame under the target is kept whole and draws nothing: at 65536
    events no demonstrator frame is cut, and the frames equal the loop's."""
    calib = _jax_rig("demo")
    got = bench_geometry.make_frames(bench_geometry.rig("demo"), 3, 65536)
    want = _jax_frames(calib, 3, 65536)
    for a, b in zip(got, want):
        assert len(a) < 65536 - 1024
        for name in b.dtype.names:
            np.testing.assert_array_equal(a[name], b[name])


@functools.lru_cache(maxsize=None)
def _engines(camera_perspective):
    kw = dict(event_capacity=4096, z_near=0.2, z_far=1.2, camera_perspective=camera_perspective)
    jeng = JEngine.from_calibration(_jax_rig("demo"), use_pallas_tail=False,
                                    use_pallas_events=False, **kw)
    teng = TEngine.from_calibration(bench_geometry.rig("demo"), device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_bench_frames_match_jax_process_frames(view):
    """The bench's 2 demonstrator frames at capacity 4096 through the
    port's ``process_frames`` (one 1-word group), equal to the JAX engine's
    ``process_frames``, and display-packed to the port's ``process_frame``."""
    jeng, teng = _engines(VIEWS[view])
    frames = bench_geometry.make_frames(bench_geometry.rig("demo"), 2, 4096)
    assert type(teng.stage_group(frames)).__name__ == "CompactStagedGroup"
    got = teng.process_frames(frames)
    for g, w in zip(got, jeng.process_frames(frames), strict=True):
        for a, b in zip(g, w, strict=True):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert int(g.num_inliers) > 0
    kw = dict(display_only=True, display_packed=True)
    for g, ev in zip(teng.process_frames(frames, **kw), frames):
        assert torch.equal(g.frame_bgr, teng.process_frame(ev, **kw).frame_bgr)


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_main_on_the_cpu(view, monkeypatch, tmp_path):
    """``main`` on the CPU at the demonstrator rig: one JSON line with the
    JAX script's keys (less the TPU plan names) and the port's, the frame
    time positive and no card."""
    monkeypatch.setenv("HOME", str(tmp_path))
    out = io.StringIO()
    argv = SMALL + (["--camera-perspective"] if VIEWS[view] else [])
    with contextlib.redirect_stdout(out):
        assert bench_geometry.main(argv) == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert doc["rect"] == [1320, 1760] and doc["xmap_shape"] == [1320, 720]
    assert doc["map_shape"] == ([480, 640] if VIEWS[view] else [901, 532])
    assert doc["geometry"] == "demo" and doc["camera_perspective"] is VIEWS[view]
    assert doc["frame_ms"] > 0 and doc["mevents_s"] > 0 and doc["vs_ref_2p67ms"] > 0
    assert doc["events_per_frame"] == doc["device_lanes_per_frame"] == 3072
    assert doc["staging"] == "compact" and doc["frames"] == 2 and doc["rounds"] == [1, 3]
    assert doc["setup_s"] > 0 and doc["compile_s"] > 0
    for key in ("gpu", "power_limit_w", "device_ms_per_frame"):
        assert doc[key] is None, key
    for key in ("winners", "event_plan", "tail_plan"):
        assert key not in doc
    assert any(p.name.startswith("xmap_") for p in (tmp_path / ".cache" /
                                                     "xmaps_tpu_torch").iterdir())


@pytest.mark.parametrize("flag", [["--winners"], ["--tail-tile", "64"], ["--no-pallas-events"],
                                  ["--no-pallas-tail"]], ids=lambda f: f[0])
def test_tpu_flags_are_refused(flag):
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit) as exc:
        bench_geometry.main(SMALL + flag)
    assert exc.value.code == 2


def test_refuses_bad_rounds_and_a_missing_card(monkeypatch):
    """Rounds that cannot be differenced raise; ``--device cuda`` without a
    card raises (no fallback to the CPU)."""
    with pytest.raises(ValueError, match="--rounds 3 3"):
        bench_geometry.main(SMALL[:-2] + ["3", "3"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench_geometry.main(["--geometry", "demo"])


def test_bench_geometry_imports_no_jax():
    """The app imports nothing of JAX or of the JAX package, in a fresh
    interpreter."""
    code = """
import sys
import xmaps_tpu_torch.apps.bench_geometry as b
b.rig("esl")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "xmaps_tpu"))
assert not loaded, loaded
print("no-jax-ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "no-jax-ok"
