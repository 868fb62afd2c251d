"""The port's streaming runtime and apps vs the JAX package's, on the CPU.

The same RAW file (a synthetic sequence with blanking gaps, from a numpy
seed) goes through ``xmaps_tpu`` and ``xmaps_tpu_torch``: the trigger
finder's frames and global indices, the staged frame program
(``process_staged``, both staging forms, both views), a whole processor
replay, and the replay CLI itself.  Every frame is compared exactly.  The
last tests run the port's two entry points in a subprocess and assert that
no module of JAX or of the JAX package was loaded.
"""

import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402, F401
from click.testing import CliRunner  # noqa: E402

from xmaps_tpu_torch.apps.make_demo_data import write_xmaps_yaml  # noqa: E402
from xmaps_tpu.apps.depth_reprojection import main as j_app  # noqa: E402
from xmaps_tpu.config import RuntimeParams as JParams  # noqa: E402
from xmaps_tpu.io.evt_encode import encode_evt2  # noqa: E402
from xmaps_tpu.io.event_iterator import FileEventsIterator as JIter  # noqa: E402
from xmaps_tpu.io.prefetch import HostStagingPool as JPool  # noqa: E402
from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.ops.filters import FILTER_NAMES as J_FILTER_NAMES  # noqa: E402
from xmaps_tpu.runtime.pipe import DepthReprojectionPipe as JPipe  # noqa: E402
from xmaps_tpu.runtime.processor import DepthReprojectionProcessor as JProc  # noqa: E402
from xmaps_tpu.runtime.processor import FakeWindow as JFakeWindow  # noqa: E402
from xmaps_tpu.runtime.trigger_finder import RobustTriggerFinder as JFinder  # noqa: E402
from xmaps_tpu.utils.stats import StatsPrinter as JStats  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration as j_calib  # noqa: E402

from xmaps_tpu_torch.apps.depth_reprojection import main as t_app  # noqa: E402
from xmaps_tpu_torch.config import RuntimeParams  # noqa: E402
from xmaps_tpu_torch.io.event_iterator import FileEventsIterator  # noqa: E402
from xmaps_tpu_torch.io.prefetch import HostStagingPool  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine  # noqa: E402
from xmaps_tpu_torch.runtime.pipe import FILTER_NAMES, DepthReprojectionPipe  # noqa: E402
from xmaps_tpu_torch.runtime.processor import (  # noqa: E402
    DepthReprojectionProcessor,
    FakeWindow,
)
from xmaps_tpu_torch.runtime.trigger_finder import RobustTriggerFinder  # noqa: E402
from xmaps_tpu_torch.utils.stats import StatsPrinter  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import (  # noqa: E402
    make_synthetic_calibration,
    simulate_sequence,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FPS = 60
DELTA_T = 1e6 / FPS / 4
CAPACITY = 16384
DEPTHS = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75]


@pytest.fixture(scope="module")
def calib():
    return make_synthetic_calibration()


@pytest.fixture(scope="module")
def raw_file(tmp_path_factory, calib):
    events = simulate_sequence(calib, DEPTHS, fps=FPS, subsample=0.6,
                               rng=np.random.default_rng(0))
    d = tmp_path_factory.mktemp("seq")
    path = d / "seq.raw"
    path.write_bytes(encode_evt2(events, calib.camera_width, calib.camera_height))
    yaml_path = d / "calib.yaml"
    write_xmaps_yaml(str(yaml_path), calib)
    return str(path), str(yaml_path)


@functools.lru_cache(maxsize=None)
def _engines(camera_perspective):
    kw = dict(event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
              camera_perspective=camera_perspective)
    return (JEngine.from_calibration(j_calib(), **kw),
            XMapsDepthEngine.from_calibration(make_synthetic_calibration(),
                                              device="cpu", **kw))


def _params(mod, calib, calib_path="<in-memory>"):
    return mod(
        camera_width=calib.camera_width, camera_height=calib.camera_height,
        projector_width=calib.projector_width,
        projector_height=calib.projector_height,
        projector_fps=FPS, z_near=0.2, z_far=1.2, calib=calib_path,
        no_frame_dropping=True,
    )


def _segment(finder_cls, stats_cls, path, iter_cls):
    """(frames, global starts, counters) of a trigger finder over the file."""
    frames, starts = [], []
    stats = stats_cls(silent=True)
    tf = finder_cls(
        projector_fps=FPS, stats=stats, frame_callback=None,
        frame_callback_indexed=lambda evs, gs: (frames.append(evs.copy()),
                                                starts.append(gs)),
    )
    for packet in iter_cls(path, delta_t=DELTA_T):
        tf.process_events(packet)
    return frames, starts, dict(stats._global.counters)


def test_trigger_finder_matches_jax(raw_file):
    path, _ = raw_file
    got = _segment(RobustTriggerFinder, StatsPrinter, path, FileEventsIterator)
    want = _segment(JFinder, JStats, path, JIter)
    assert len(got[0]) == len(want[0]) >= len(DEPTHS) - 2
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == want[1]
    assert got[2] == want[2]


def _frames(path):
    return _segment(RobustTriggerFinder, StatsPrinter, path, FileEventsIterator)[0]


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "two_word"])
def test_process_staged_matches_jax(raw_file, camera_perspective, compact):
    """The port's staged frame program equals the JAX engine's streaming
    program bit for bit: the packed-BGR plane and the inlier count."""
    jeng, teng = _engines(camera_perspective)
    assert tuple(teng.compact_layout) == tuple(jeng.compact_layout)
    pool = HostStagingPool(CAPACITY, device="cpu", layout=teng.compact_layout)
    jpool = JPool(CAPACITY, layout=jeng.compact_layout)
    frames = _frames(raw_file[0])
    for ev in frames + [frames[0][:0]]:
        if compact:
            got = teng.process_staged(pool.stage_compact(ev))
            want = jeng.process_staged(jpool.stage_compact(ev))
        else:
            got = teng.process_staged(pool.stage(ev))
            want = jeng.process_staged(jpool.stage(ev))
        assert got.depth is None and got.disp_map is None
        assert got.frame_bgr.dtype == torch.int32
        np.testing.assert_array_equal(got.frame_bgr.numpy().view(np.uint32),
                                      np.asarray(want.frame_bgr))
        assert int(got.num_inliers) == int(want.num_inliers)
    assert int(got.num_inliers) == 0  # the empty frame


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
def test_process_staged_compact_at_capacity_matches_jax(raw_file, camera_perspective):
    """1-word staging (kernel 1's staged entry) on frames truncated at a
    capacity below their event count, so the count equals the capacity,
    and at one event: the JAX engine's frame bit for bit."""
    cap = 1024
    kw = dict(event_capacity=cap, z_near=0.2, z_far=1.2, camera_perspective=camera_perspective)
    jeng = JEngine.from_calibration(j_calib(), **kw)
    teng = XMapsDepthEngine.from_calibration(make_synthetic_calibration(), device="cpu", **kw)
    pool = HostStagingPool(cap, device="cpu", layout=teng.compact_layout)
    jpool = JPool(cap, layout=jeng.compact_layout)
    frames = _frames(raw_file[0])[:2]
    assert min(len(ev) for ev in frames) > cap
    for ev in frames + [frames[0][:1]]:
        staged = pool.stage_compact(ev)
        assert staged.count == min(len(ev), cap)
        got = teng.process_staged(staged)
        want = jeng.process_staged(jpool.stage_compact(ev))
        np.testing.assert_array_equal(got.frame_bgr.numpy().view(np.uint32),
                                      np.asarray(want.frame_bgr))
        assert int(got.num_inliers) == int(want.num_inliers)
    assert int(got.num_inliers) <= 1


def _processor(pipe_cls, proc_cls, stats_cls, window_cls, params, engine, **pipe_kw):
    shown = []
    proc = proc_cls(params=params, stats_printer=stats_cls(silent=True))
    proc._pipe = pipe_cls(params=params, stats_printer=proc.stats_printer,
                          frame_callback=shown.append, engine=engine, **pipe_kw)
    proc._window = window_cls()
    return proc, shown


def _replay(proc, iter_cls, path, passes=1):
    for i in range(passes):
        if i:
            proc.reset()
        for packet in iter_cls(path, delta_t=DELTA_T):
            proc.process_events(packet)
        proc._pipe.flush()
    return dict(proc.stats_printer._global.counters)


def _port_processor(calib, **kw):
    return _processor(DepthReprojectionPipe, DepthReprojectionProcessor, StatsPrinter,
                      FakeWindow, _params(RuntimeParams, calib), _engines(False)[1], **kw)


def test_processor_replay_matches_jax(raw_file, calib):
    """The whole slice: packets -> activity filter -> trigger finder ->
    staging -> engine -> display, every delivered frame and the counts
    equal to the JAX processor's (which prestages through its packet ring)."""
    path, _ = raw_file
    proc, shown = _port_processor(calib)
    jproc, jshown = _processor(JPipe, JProc, JStats, JFakeWindow,
                               _params(JParams, calib), _engines(False)[0])
    got, want = _replay(proc, FileEventsIterator, path), _replay(jproc, JIter, path)
    assert len(shown) == len(jshown) >= len(DEPTHS) - 2
    for a, b in zip(shown, jshown):
        assert a.shape == (calib.projector_height, calib.projector_width, 3)
        assert a.dtype == np.uint8 and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
    for name in ("trig ok", "trig fail", "frames dispatched", "processed evs"):
        assert got.get(name) == want.get(name), name
    assert got["frames dispatched"] == got["trig ok"] == len(shown)
    assert (shown[0] != 255).any(axis=-1).mean() > 0.1


def test_ring_prestage_matches_segmented(raw_file, calib):
    """The port pipe prestages through its packet ring by default: its
    frames equal those of a ``prestage=False`` pipe (segmented staging) and
    of the JAX pipe (which prestages), and the ring is really used (packets
    staged, no overrun, no ``ring fallback``, every dispatched frame
    shown)."""
    path, _ = raw_file
    runs = {}
    for prestage in (True, False):
        proc, shown = _port_processor(calib, prestage=prestage)
        runs[prestage] = (proc, shown, _replay(proc, FileEventsIterator, path))
    jproc, jshown = _processor(JPipe, JProc, JStats, JFakeWindow,
                               _params(JParams, calib), _engines(False)[0])
    jcounters = _replay(jproc, JIter, path)
    (proc, shown, counters), (seg, seg_shown, seg_counters) = runs[True], runs[False]
    ring = proc._pipe.ring
    assert ring is not None and seg._pipe.ring is None
    assert ring.packets_staged == jproc._pipe.ring.packets_staged > 0
    assert ring.overruns == 0
    assert counters.get("ring fallback", 0) == jcounters.get("ring fallback", 0) == 0
    assert counters["frames dispatched"] == seg_counters["frames dispatched"] == len(shown)
    assert len(shown) == len(seg_shown) == len(jshown) >= len(DEPTHS) - 2
    for a, b, c in zip(shown, seg_shown, jshown):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_prestage_skipped_while_behind(raw_file, calib):
    """While the watchdog is dropping frames, packet bytes are not
    pre-staged (the ring numbering advances without staging); once caught
    up, staging resumes and frames still come out -- the same frames, ring
    fallbacks and staged packets as the JAX pipe under the same forced
    lag."""
    path, _ = raw_file

    def run(proc, iter_cls):
        proc.params.no_frame_dropping = False
        wd = proc._pipe.watchdog
        orig, calls = wd.is_processing_behind, []

        def fake_behind(evs):
            orig(evs)  # keep internal state ticking
            calls.append(1)
            return len(calls) <= 10

        wd.is_processing_behind = fake_behind
        counters = _replay(proc, iter_cls, path)
        return counters, len(calls)

    proc, shown = _port_processor(calib)
    jproc, jshown = _processor(JPipe, JProc, JStats, JFakeWindow,
                               _params(JParams, calib), _engines(False)[0])
    (counters, n_calls), (jcounters, _) = run(proc, FileEventsIterator), run(jproc, JIter)
    ring = proc._pipe.ring
    # the 10 behind packets were skipped, not staged
    assert 0 < ring.packets_staged <= n_calls - 10
    assert ring.packets_staged == jproc._pipe.ring.packets_staged
    # the global numbering stayed consistent: later frames still decode
    assert len(shown) == len(jshown) >= 1
    for a, b in zip(shown, jshown):
        np.testing.assert_array_equal(a, b)
    for name in ("ring fallback", "frames dispatched", "trig ok"):
        assert counters.get(name, 0) == jcounters.get(name, 0), name


def test_frame_wanted_gates_display_fetch(raw_file, calib):
    """A sink that wants every 2nd frame receives exactly those; the others
    are computed (stats counter) but their image is never fetched."""
    proc, shown = _port_processor(calib)
    calls = []

    def every_other():
        calls.append(len(calls))
        return calls[-1] % 2 == 0

    proc._pipe.frame_wanted = every_other
    counters = _replay(proc, FileEventsIterator, raw_file[0])
    assert len(calls) >= len(DEPTHS) - 2
    assert len(shown) == (len(calls) + 1) // 2
    assert counters["frames computed (display skipped)"] == len(calls) - len(shown)


def test_reset_supports_loop_replay(raw_file, calib):
    """reset() lets the same processor replay the stream again
    (--loop-input), with the same frames."""
    proc, shown = _port_processor(calib, low_latency=True)
    _replay(proc, FileEventsIterator, raw_file[0], passes=2)
    assert len(shown) >= 2 and len(shown) % 2 == 0
    half = len(shown) // 2
    for a, b in zip(shown[:half], shown[half:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prestage", [True, False])
def test_frame_filter_cycle_is_not_ported(raw_file, calib, prestage):
    """The E key cycles all five dedup filters, in the JAX package's order
    and back to "none".  With one press (first_per_yt) the processor
    replays the file, every delivered frame equal to the JAX processor's
    after the same key: with ``prestage`` (the pipe's default) every frame
    from the packet ring (no ``ring fallback``, no overrun, no segmented
    staging), without it every frame through the 2-word segmented staging.
    (The name is the one the test had while the port refused the cycle; it
    is kept so that the test's history stays one test.)"""
    path, _ = raw_file
    assert FILTER_NAMES == J_FILTER_NAMES
    proc, shown = _port_processor(calib, prestage=prestage)
    jproc, jshown = _processor(JPipe, JProc, JStats, JFakeWindow,
                               _params(JParams, calib), _engines(False)[0])
    stage_calls = []
    staging = proc._pipe.staging
    orig_stage, orig_compact = staging.stage, staging.stage_compact
    staging.stage = lambda evs: stage_calls.append(len(evs)) or orig_stage(evs)
    staging.stage_compact = lambda evs: stage_calls.append(-len(evs)) or orig_compact(evs)
    try:
        for p in (proc, jproc):
            p.keyboard_cb(ord("e"))
        assert proc._pipe.engine.cfg.frame_filter == J_FILTER_NAMES[1]
        got, want = _replay(proc, FileEventsIterator, path), _replay(jproc, JIter, path)
        assert len(shown) == len(jshown) == got["frames dispatched"] >= len(DEPTHS) - 2
        for a, b in zip(shown, jshown):
            np.testing.assert_array_equal(a, b)
        assert got["frames dispatched"] == want["frames dispatched"]
        if prestage:
            assert stage_calls == []
            assert got.get("ring fallback", 0) == 0 and proc._pipe.ring.overruns == 0
        else:
            assert proc._pipe.ring is None
            assert len(stage_calls) == len(shown) and min(stage_calls) > 0
        names = [proc._pipe.select_next_frame_event_filter() for _ in J_FILTER_NAMES]
        assert names == list(J_FILTER_NAMES[2:] + J_FILTER_NAMES[:2])
    finally:
        for p in (proc, jproc):
            p._pipe.engine.set_frame_filter("none")


STAT_KEYS = ("trig ok", "frames shown", "frames computed (display skipped)")


def _stats(output):
    """The final dashboard's counters of STAT_KEYS."""
    out = {}
    for key in STAT_KEYS:
        # the last match: a slow run prints intermediate dashboards first
        found = re.findall(rf"^  {re.escape(key)}\s+(\d+)$", output, re.M)
        out[key] = int(found[-1]) if found else 0
    return out


def test_app_cli_matches_jax_app(raw_file, tmp_path, monkeypatch):
    """``python -m xmaps_tpu_torch.apps.depth_reprojection --device cpu``
    against the JAX app on the same file: equal segmentation and display
    counts, and the PNG the file sink writes (frame 0) equal byte for
    byte in its pixels."""
    from PIL import Image

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    path, yaml_path = raw_file
    args = ["--calib", yaml_path, "--input", path, "--projector-width", "90",
            "--projector-height", "160", "--camera-width", "64", "--camera-height", "48",
            "--z-near", "0.2", "--z-far", "1.2", "--no-frame-dropping", "--window", "files"]
    runs = {}
    for name, app, extra in (("port", t_app, ["--device", "cpu"]), ("jax", j_app, [])):
        out = tmp_path / name
        res = CliRunner().invoke(app, args + extra + ["--out-dir", str(out)])
        assert res.exit_code == 0, (res.output, res.exception)
        runs[name] = (_stats(res.output), sorted(p.name for p in out.iterdir()), out)
    (tstats, tpngs, tout), (jstats, jpngs, jout) = runs["port"], runs["jax"]
    assert tstats == jstats
    assert tstats["frames shown"] + tstats["frames computed (display skipped)"] \
        == tstats["trig ok"] >= len(DEPTHS) - 2
    assert tpngs == jpngs == ["depth_000000.png"]
    np.testing.assert_array_equal(np.asarray(Image.open(tout / tpngs[0])),
                                  np.asarray(Image.open(jout / jpngs[0])))


def test_app_refuses_live_capture_and_missing_card(raw_file, monkeypatch, tmp_path):
    """Without --input the app captures live: with no backend named (and
    no hardware backend registered) it refuses with the registry's
    message; ``--capture synthetic`` runs the live path, stopped here
    through the window's close request after two frames (the ports of the
    capture tests are in tests/test_torch_capture.py).  Without a card,
    ``--device cuda`` (the default) raises.  (The name is the one the test
    had while the port refused live capture; it is kept so that the test's
    history stays one test.)"""
    path, yaml_path = raw_file
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("XMAPS_CAPTURE_BACKEND", raising=False)
    live = ["--calib", yaml_path, "--projector-width", "90", "--projector-height", "160",
            "--camera-width", "64", "--camera-height", "48", "--device", "cpu"]
    res = CliRunner().invoke(t_app, live)
    assert isinstance(res.exception, RuntimeError), res.output
    assert "No capture backend selected" in str(res.exception)
    monkeypatch.setattr(
        DepthReprojectionProcessor, "should_close",
        lambda self: self.stats_printer._global.counters.get("frames dispatched", 0) >= 2)
    res = CliRunner().invoke(t_app, live + ["--capture", "synthetic"])
    assert res.exit_code == 0, (res.output, res.exception)
    assert _stats(res.output)["trig ok"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = CliRunner().invoke(t_app, ["--calib", yaml_path, "--input", path,
                                     "--camera-width", "64", "--camera-height", "48"])
    assert isinstance(res.exception, RuntimeError) and "is_available" in str(res.exception)


_REPLAY = """
import sys
from click.testing import CliRunner
import numpy as np
from xmaps_tpu_torch.apps.make_demo_data import write_xmaps_yaml
from xmaps_tpu_torch.apps.depth_reprojection import main
from xmaps_tpu_torch.io.evt_encode import encode_evt3
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration, simulate_sequence
calib = make_synthetic_calibration()
ev = simulate_sequence(calib, [0.5, 0.6, 0.7, 0.8], subsample=0.6, rng=np.random.default_rng(1))
open("seq.raw", "wb").write(encode_evt3(ev, 64, 48))
write_xmaps_yaml("calib.yaml", calib)
res = CliRunner().invoke(main, ["--calib", "calib.yaml", "--input", "seq.raw",
    "--projector-width", "90", "--projector-height", "160", "--camera-width", "64",
    "--camera-height", "48", "--no-frame-dropping", "--device", "cpu"])
assert res.exit_code == 0, (res.output, res.exception)
assert "frames shown" in res.output, res.output
"""

_BENCH = """
import sys
from xmaps_tpu_torch.apps.bench import main
assert main(["--device", "cpu", "--camera", "64", "48", "--projector", "90", "160"]) == 0
"""

_STORE_LOOP = """
import sys
from xmaps_tpu_torch.apps.bench_store_loop import main
assert main(["--device", "cpu"]) == 0
"""

_BENCH_STREAM = """
import os
import sys
import torch
from xmaps_tpu_torch.apps.bench_stream import main
torch.set_num_threads(1)  # the demonstrator rig: keep one core beside the other test workers
os.environ["XMAPS_BENCH_STREAM_FRAMES"] = "6"
assert main(["--device", "cpu"]) == 0
"""

_DEMO_DATA = """
import sys
from xmaps_tpu_torch.apps.make_demo_data import main
assert main(["--out-dir", "demo", "--frames", "3", "--camera-width", "96", "--camera-height",
             "72", "--projector-width", "64", "--projector-height", "96"]) == 0
"""

_LIVE = """
import sys
from click.testing import CliRunner
from xmaps_tpu_torch.apps.make_demo_data import write_xmaps_yaml
from xmaps_tpu_torch.apps.depth_reprojection import main
from xmaps_tpu_torch.runtime.processor import DepthReprojectionProcessor
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration
write_xmaps_yaml("calib.yaml", make_synthetic_calibration())
DepthReprojectionProcessor.should_close = (
    lambda self: self.stats_printer._global.counters.get("frames dispatched", 0) >= 2)
res = CliRunner().invoke(main, ["--calib", "calib.yaml", "--capture", "synthetic",
    "--projector-width", "90", "--projector-height", "160", "--camera-width", "64",
    "--camera-height", "48", "--device", "cpu"])
assert res.exit_code == 0, (res.output, res.exception)
assert "frames shown" in res.output, res.output
"""


@pytest.mark.parametrize("entry", ["replay", "bench", "store_loop", "live", "bench_stream",
                                   "make_demo_data"])
def test_entry_points_in_subprocess_never_load_jax(entry, tmp_path):
    """The replay app, the bench, the store-loop bench, the live path
    (``io.capture``), the streaming bench (``XMAPS_BENCH_STREAM_FRAMES=6``,
    its fixed demonstrator rig) and the demo-data generator on the CPU, in a fresh
    interpreter: they run, the benches print one parseable JSON line with
    their keys, and no module of JAX or of the JAX package is ever
    imported."""
    code = {"replay": _REPLAY, "bench": _BENCH, "store_loop": _STORE_LOOP,
            "live": _LIVE, "bench_stream": _BENCH_STREAM,
            "make_demo_data": _DEMO_DATA}[entry] + """
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "xmaps_tpu"))
assert not loaded, loaded
print("no-jax-ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "no-jax-ok"
    if entry == "bench":
        result = json.loads(lines[-2])
        assert result["metric"] == "Mevents/s/chip" and result["unit"] == "Mevents/s"
        assert result["value"] > 0 and result["vs_baseline"] > 0
        extra = result["extra"]
        assert extra["device"] == "cpu" and extra["gpu"] is None
        assert extra["p50_ms_sync"] > 0 and extra["events_per_frame"] > 100
        # the group regime (value) beside the per-frame loop, in one line
        assert extra["frame_ms_pipelined"] > 0 and extra["frame_ms_loop"] > 0
        assert extra["frames_per_group"] == 12
    if entry == "store_loop":
        result = json.loads(lines[-2])
        assert result["device"] == "cpu" and result["gpu"] is None
        assert result["events"] == 28 * 1024 and result["library_equal"] is True
        assert min(result[f"{k}_ns_per_store"] for k in ("kernel", "plain", "library")) > 0
    if entry == "bench_stream":
        result = json.loads(lines[-2])
        assert result["metric"] == "stream_p50_latency_ms" and result["unit"] == "ms"
        assert result["value"] > 0 and result["vs_baseline"] > 0
        extra = result["extra"]
        for key in ("p95_ms", "p50_segmented_staging_ms", "p50_host_framework_work_ms",
                    "p50_host_handover_to_dispatch_ms", "frame_path_fallback_frames",
                    "ring_packets_per_frame_mode", "ring_staged_bytes_per_frame",
                    "display_fetch_ms", "frames_measured", "events_per_frame", "setup_s"):
            assert extra[key] is not None and extra[key] >= 0, key
        assert extra["device"] == "cpu" and extra["gpu"] is None
        assert extra["p50_device_frame_path_ms"] is None
        assert extra["frames_measured"] >= 1 and extra["events_per_frame"] > 1000
        assert extra["ring_packets_per_frame_mode"] >= 1
        assert not {"tunnel_rtt_p50_ms", "p50_ms_rtt_adjusted"} & set(extra)
    if entry == "make_demo_data":
        assert {p.name for p in (tmp_path / "demo").iterdir()} == {"calibration.yaml",
                                                                   "events.raw"}
