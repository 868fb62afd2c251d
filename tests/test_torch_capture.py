"""The port's live-capture seam (``xmaps_tpu_torch.io.capture``,
``io.capture_metavision``, ``io.biases``) against the JAX package's.

Ports of ``tests/test_capture.py`` (backend registry, bias plumbing, the
synthetic backend's wall-clock stream through the trigger finder) and
``tests/test_capture_metavision.py`` (the Metavision adapter against a
faked SDK), run against the port.  Then: the modules are the JAX package's
apart from their imports and docstrings, the synthetic session's packets
equal the JAX session's for the same seed, and the replay app's live path
(no ``--input``) segments and computes frames on the CPU, bounded through
the processor's ``should_close``.
"""

import ast
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from click.testing import CliRunner  # noqa: E402

from chip_smoke import write_xmaps_yaml  # noqa: E402
from xmaps_tpu.io.capture import open_capture as j_open_capture  # noqa: E402

import xmaps_tpu_torch.io.capture as capture  # noqa: E402
from xmaps_tpu_torch.apps.depth_reprojection import main as t_app  # noqa: E402
from xmaps_tpu_torch.io import biases  # noqa: E402
from xmaps_tpu_torch.io.capture import (  # noqa: E402
    CaptureBackend,
    CaptureSession,
    LiveEventsIterator,
    capture_backends,
    open_capture,
    register_capture_backend,
)
from xmaps_tpu_torch.io.evt_decoder import EVENT_DTYPE  # noqa: E402
from xmaps_tpu_torch.runtime.processor import DepthReprojectionProcessor  # noqa: E402
from xmaps_tpu_torch.runtime.trigger_finder import RobustTriggerFinder  # noqa: E402
from xmaps_tpu_torch.utils.stats import StatsPrinter  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# -- the registry and the bias plumbing (tests/test_capture.py) -------------


class _DummySession(CaptureSession):
    def __init__(self, serial):
        self.serial = serial
        self.biases = None

    def get_size(self):
        return 48, 64

    def set_biases(self, biases):
        self.biases = dict(biases)

    def packets(self, delta_t):
        ev = np.zeros(4, dtype=EVENT_DTYPE)
        ev["t"] = np.arange(4) * int(delta_t)
        yield ev


class _DummyBackend(CaptureBackend):
    name = "dummy-hw"

    def open(self, serial="", **hints):
        return _DummySession(serial)


@pytest.fixture
def dummy_registered():
    saved = dict(capture._REGISTRY)
    register_capture_backend(_DummyBackend())
    yield
    capture._REGISTRY.clear()
    capture._REGISTRY.update(saved)


def test_registry_and_selection(dummy_registered, monkeypatch):
    assert "synthetic" in capture_backends()
    assert "dummy-hw" in capture_backends()
    # explicit name + serial
    assert open_capture("dummy-hw:abc123").serial == "abc123"
    # auto-selection picks the sole hardware backend (never synthetic)
    monkeypatch.delenv("XMAPS_CAPTURE_BACKEND", raising=False)
    assert isinstance(open_capture(""), _DummySession)
    # env var selection
    monkeypatch.setenv("XMAPS_CAPTURE_BACKEND", "dummy-hw:env7")
    assert open_capture("").serial == "env7"
    with pytest.raises(RuntimeError, match="Unknown capture backend"):
        open_capture("nope")


def test_auto_selection_requires_a_hardware_backend(monkeypatch):
    monkeypatch.delenv("XMAPS_CAPTURE_BACKEND", raising=False)
    # only 'synthetic' registered (no Metavision SDK) -> must be named
    assert sorted(capture_backends()) == ["synthetic"]
    with pytest.raises(RuntimeError, match="No capture backend selected"):
        open_capture("")


def test_bias_file_is_programmed(dummy_registered, tmp_path):
    bias_path = tmp_path / "cam.bias"
    bias_path.write_text("300 % bias_diff\n221 % bias_diff_off\n")
    s = open_capture("dummy-hw", bias_file=str(bias_path))
    assert s.biases == {"bias_diff": 300, "bias_diff_off": 221}


def test_synthetic_live_stream_segments_into_frames():
    """The synthetic backend's wall-clock stream flows through the
    packetize -> trigger-finder path and yields whole frames."""
    fps = 60
    session = open_capture(
        "synthetic:5", camera_width=64, camera_height=48, projector_width=90,
        projector_height=160, projector_fps=fps, depths=[0.5, 0.55, 0.6, 0.65, 0.7],
        events_per_frame=2000,
    )
    assert session.get_size() == (48, 64)
    frames = []
    tf = RobustTriggerFinder(projector_fps=fps, stats=StatsPrinter(silent=True),
                             frame_callback=lambda evs: frames.append(evs.copy()))
    t0 = time.perf_counter()
    for pkt in LiveEventsIterator(session, delta_t=1e6 / fps / 4):
        if len(pkt):
            tf.process_events(pkt)
    wall = time.perf_counter() - t0
    assert len(frames) >= 3  # interior frames of 5
    for f in frames:
        assert 1e6 / fps / 2 < f["t"][-1] - f["t"][0] <= 1e6 / fps
        assert len(f) > 1000
    # real-time pacing: 5 frames at 60 Hz take >= ~66 ms of wall clock
    assert wall >= 0.05


def test_synthetic_packets_match_jax():
    """Same seed, same hints: the same packets as the JAX session (one
    pass), and the same programmed biases."""
    hints = dict(camera_width=64, camera_height=48, projector_width=90,
                 projector_height=160, projector_fps=60, depths=[0.5, 0.6, 0.7],
                 events_per_frame=1500)
    got = open_capture("synthetic:3", **hints)
    want = j_open_capture("synthetic:3", **hints)
    a = list(got.packets(1e6 / 60 / 4))
    b = list(want.packets(1e6 / 60 / 4))
    assert len(a) == len(b) > 8
    for pa, pb in zip(a, b):
        assert pa.dtype == pb.dtype == EVENT_DTYPE
        np.testing.assert_array_equal(pa, pb)
    got.set_biases({"bias_fo": 1700})
    assert got.programmed_biases == {"bias_fo": 1700}


def test_biases_match_jax(tmp_path):
    from xmaps_tpu.io import biases as jbiases

    path = tmp_path / "cam.bias"
    path.write_text("% comment\n300 % bias_diff\n\n1700 % bias_fo\n-5 % bias_x\n")
    assert biases.load_bias_file(str(path)) == jbiases.load_bias_file(str(path))
    t, j = biases.Biases(), jbiases.Biases()
    for op in ["cycle", "inc", "inc", "dec", "cycle", "dec", "cycle"] * 6:
        got = {"cycle": t.cycle_current_bias, "inc": lambda: t.increase_current(100),
               "dec": lambda: t.decrease_current(100)}[op]()
        want = {"cycle": j.cycle_current_bias, "inc": lambda: j.increase_current(100),
                "dec": lambda: j.decrease_current(100)}[op]()
        assert got == want
    assert t.biases == j.biases


def _ast_without_imports_and_docstrings(path):
    """The module's AST with every import statement and every docstring
    taken out."""

    class Strip(ast.NodeTransformer):
        def visit_Import(self, node):
            return None

        def visit_ImportFrom(self, node):
            return None

        def generic_visit(self, node):
            node = super().generic_visit(node)
            body = getattr(node, "body", None)
            if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
            return node

    return ast.dump(Strip().visit(ast.parse(path.read_text())))


@pytest.mark.parametrize("module", ["biases.py", "capture.py", "capture_metavision.py"])
def test_capture_copies_equal_apart_from_imports(module):
    port = REPO / "xmaps_tpu_torch" / "io" / module
    assert (_ast_without_imports_and_docstrings(port)
            == _ast_without_imports_and_docstrings(REPO / "xmaps_tpu" / "io" / module))
    imports = [n for n in ast.walk(ast.parse(port.read_text()))
               if isinstance(n, (ast.Import, ast.ImportFrom))]
    for node in imports:
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
        assert all(n.split(".")[0] not in ("jax", "xmaps_tpu") for n in names if n), names


# -- the Metavision adapter against a faked SDK -----------------------------
# (tests/test_capture_metavision.py)

MV_DTYPE = np.dtype([("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<i8")])


class _FakeGeometry:
    def get_width(self):
        return 640

    def get_height(self):
        return 480


class _FakeBiases:
    def __init__(self):
        self.written = {}

    def set(self, name, value):
        self.written[name] = value


class _FakeDevice:
    def __init__(self, serial):
        self.serial = serial
        self.biases = _FakeBiases()

    def get_i_geometry(self):
        return _FakeGeometry()

    def get_i_ll_biases(self):
        return self.biases


def _fake_packets():
    rng = np.random.default_rng(0)
    out, t = [], 0
    for _ in range(3):
        n = int(rng.integers(50, 200))
        ev = np.zeros(n, MV_DTYPE)
        ev["x"] = rng.integers(0, 640, n)
        ev["y"] = rng.integers(0, 480, n)
        ev["p"] = rng.integers(0, 2, n)
        ev["t"] = t + np.sort(rng.integers(0, 4000, n))
        t += 4000
        out.append(ev)
    return out


@pytest.fixture()
def fake_sdk(monkeypatch):
    packets = _fake_packets()
    opened = {}
    hal = types.ModuleType("metavision_hal")

    class DeviceDiscovery:
        @staticmethod
        def open(serial):
            if serial == "missing":
                return None
            opened["device"] = _FakeDevice(serial)
            return opened["device"]

    hal.DeviceDiscovery = DeviceDiscovery
    core = types.ModuleType("metavision_core")
    event_io = types.ModuleType("metavision_core.event_io")

    class EventsIterator:
        def __init__(self, input_path, delta_t):
            assert input_path is opened["device"]
            opened["delta_t"] = delta_t

        def __iter__(self):
            return iter(packets)

    event_io.EventsIterator = EventsIterator
    core.event_io = event_io
    monkeypatch.setitem(sys.modules, "metavision_hal", hal)
    monkeypatch.setitem(sys.modules, "metavision_core", core)
    monkeypatch.setitem(sys.modules, "metavision_core.event_io", event_io)
    return packets, opened


def test_adapter_end_to_end(fake_sdk):
    packets, opened = fake_sdk
    from xmaps_tpu_torch.io.capture_metavision import MetavisionCaptureBackend

    session = MetavisionCaptureBackend().open("serial42")
    assert opened["device"].serial == "serial42"
    assert session.get_size() == (480, 640)  # (height, width) orientation
    session.set_biases({"bias_diff_on": 300, "bias_fo": -10})
    assert opened["device"].biases.written == {"bias_diff_on": 300, "bias_fo": -10}
    got = list(session.packets(delta_t=4166))
    assert opened["delta_t"] == 4166
    assert len(got) == len(packets)
    for g, ref in zip(got, packets):
        assert g.dtype == EVENT_DTYPE
        for f in ("x", "y", "p", "t"):
            np.testing.assert_array_equal(g[f], ref[f])


def test_adapter_no_camera(fake_sdk):
    from xmaps_tpu_torch.io.capture_metavision import MetavisionCaptureBackend

    with pytest.raises(RuntimeError, match="No Prophesee camera"):
        MetavisionCaptureBackend().open("missing")


def test_adapter_close_stops_stream(fake_sdk):
    from xmaps_tpu_torch.io.capture_metavision import MetavisionCaptureBackend

    session = MetavisionCaptureBackend().open("")
    it = session.packets(delta_t=1000)
    assert len(next(it))
    session.close()
    assert list(it) == []


def test_registry_integration(fake_sdk, monkeypatch, tmp_path):
    """With the (faked) SDK importable, register_metavision_backend adds
    the backend and open_capture auto-picks it as the sole hardware
    backend, programming biases from the .bias file.  Without the SDK the
    module registered nothing (test_auto_selection_requires_a_hardware_backend)."""
    from xmaps_tpu_torch.io.capture_metavision import register_metavision_backend

    monkeypatch.setattr(capture, "_REGISTRY", dict(capture._REGISTRY), raising=True)
    monkeypatch.delenv("XMAPS_CAPTURE_BACKEND", raising=False)
    assert register_metavision_backend() is True
    assert "metavision" in capture.capture_backends()
    bias_path = tmp_path / "live_cam.bias"
    bias_path.write_text("1700 % bias_fo\n1500 % bias_hpf\n320 % bias_diff_on\n")
    session = capture.open_capture("", bias_file=str(bias_path))
    assert session.get_size() == (480, 640)
    assert fake_sdk[1]["device"].biases.written == biases.load_bias_file(str(bias_path))


# -- the app's live path ----------------------------------------------------


def test_app_live_capture_segments_frames(tmp_path, monkeypatch):
    """``--capture synthetic`` without ``--input`` on the CPU: the paced
    stream reaches the trigger finder and the engine; the run is bounded
    through the processor's ``should_close`` (the live stream never ends
    on its own), and the app exits 0 with the frames counted."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    calib = make_synthetic_calibration()
    yaml_path = tmp_path / "calib.yaml"
    write_xmaps_yaml(str(yaml_path), calib)
    seen = {}

    def should_close(self):
        seen["counters"] = dict(self.stats_printer._global.counters)
        return seen["counters"].get("frames dispatched", 0) >= 4

    monkeypatch.setattr(DepthReprojectionProcessor, "should_close", should_close)
    t0 = time.perf_counter()
    res = CliRunner().invoke(t_app, [
        "--calib", str(yaml_path), "--capture", "synthetic:4", "--projector-width", "90",
        "--projector-height", "160", "--camera-width", "64", "--camera-height", "48",
        "--z-near", "0.2", "--z-far", "1.2", "--no-frame-dropping", "--device", "cpu"])
    wall = time.perf_counter() - t0
    assert res.exit_code == 0, (res.output, res.exception)
    counters = seen["counters"]
    assert counters["frames dispatched"] == counters["trig ok"] == 4
    assert "frames shown" in res.output
    # paced: four frames at 60 Hz after the first trigger
    assert wall >= 4 / 60
