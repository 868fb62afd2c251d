"""The port's tracer (``xmaps_tpu_torch.utils.stats``: ``span``, ``records``)
and the spans at its layer boundaries, on the CPU.

The tracer records only while a ``torch.profiler`` session records: off,
``span`` is one shared no-op context.  On, nested spans link to the span
open around them, times are on ``time.perf_counter``, a full buffer drops
and counts, and a short EVT3 replay through ``DepthReprojectionPipe`` and a
group's staging leave the spans the benchmark's per-layer metrics read.
The one ``gpu`` test holds the shared clock against the card's: each kernel
of an ESL group call starts after the ``kernel.launch`` span that issued it.
These tests import nothing of JAX.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from xmaps_tpu_torch.config import RuntimeParams  # noqa: E402
from xmaps_tpu_torch.io.evt_encode import encode_evt3  # noqa: E402
from xmaps_tpu_torch.io.event_iterator import FileEventsIterator  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine  # noqa: E402
from xmaps_tpu_torch.ops.frame_pipeline import group_depth_frames  # noqa: E402
from xmaps_tpu_torch.runtime.pipe import DepthReprojectionPipe  # noqa: E402
from xmaps_tpu_torch.utils import stats  # noqa: E402
from xmaps_tpu_torch.utils.stats import StatsPrinter, records, span  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import (  # noqa: E402
    make_synthetic_calibration,
    simulate_plane_events,
    simulate_sequence,
)

FPS = 60
DEPTHS = [0.5, 0.55, 0.6, 0.65, 0.7]


@pytest.fixture(autouse=True)
def empty_trace():
    stats.clear()
    yield
    stats.clear()


def recording():
    """A CPU profiler session: the tracer records while it is open."""
    return profile(activities=[ProfilerActivity.CPU])


def spin(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def children(recs, i, name=None):
    """The indices of the spans whose parent is ``i``."""
    return [j for j, r in enumerate(recs) if r.parent == i and (name is None or r.name == name)]


def named(recs, name):
    return [i for i, r in enumerate(recs) if r.name == name]


def test_off_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("a") is span("b", 3) is stats._OFF
    with span("a"):
        pass
    sp = StatsPrinter(silent=True)
    with sp.measure_time("timer"):
        sp.count("counter")
    assert records() == [] and stats.dropped() == 0
    assert sp._global.counters == {"counter": 1} and sp._global.times_ns["timer"].n == 1


def test_nested_spans_link_and_self_time():
    with recording():
        t0 = time.perf_counter()
        with span("outer", 7):
            spin(0.002)
            with span("inner"):
                spin(0.003)
            with span("inner"):
                with span("leaf"):
                    pass
        t1 = time.perf_counter()
    recs = records()
    assert [r.name for r in recs] == ["outer", "inner", "inner", "leaf"]
    assert [r.parent for r in recs] == [None, 0, 0, 2]
    assert recs[0].tag == 7 and recs[1].tag is None
    assert all(t0 <= r.start <= r.end <= t1 for r in recs)
    assert recs[1].start >= recs[0].start and recs[2].end <= recs[0].end
    kids = sum(recs[j].end - recs[j].start for j in children(recs, 0))
    own = recs[0].end - recs[0].start - kids
    assert 0.002 <= own <= (t1 - t0) - 0.003
    assert recs[1].end - recs[1].start >= 0.003
    # after the session: off again
    with span("late"):
        pass
    assert len(records()) == 4


def test_full_buffer_drops_and_counts(monkeypatch):
    monkeypatch.setattr(stats, "TRACE_CAPACITY", 3)
    with recording():
        with span("a"):
            with span("b"):
                with span("c"):
                    pass
            with span("d"):  # dropped: its exit leaves the stack as it was
                with span("e"):  # dropped
                    pass
            with span("f"):
                pass
        with span("g"):
            pass
    recs = records()
    assert [r.name for r in recs] == ["a", "b", "c"]
    assert [r.parent for r in recs] == [None, 0, 1]
    assert all(r.end is not None for r in recs)
    assert stats.dropped() == 4
    assert stats._stack == []


def test_dashboard_counters_leave_no_record():
    """The dashboard's counters count while a profiler records, and stay
    the dashboard's: no metric reads them from the trace."""
    sp = StatsPrinter(silent=True)
    with recording():
        with span("frame"):
            sp.count("trig ok")
            sp.count("trig span too long", 2)
    assert [r.name for r in records()] == ["frame"]
    assert sp._global.counters == {"trig ok": 1, "trig span too long": 2}


def test_dashboard_timer_is_the_span(monkeypatch):
    """``measure_time`` is the dashboard's timer (``add_time_measure_ns``
    stays its sink) and a span that starts at the timer's own clock read and
    ends before the timer's last read."""
    seen = []
    sp = StatsPrinter(silent=True)
    orig = StatsPrinter.add_time_measure_ns

    def sink(self, name, ns):
        seen.append((name, ns))
        orig(self, name, ns)

    monkeypatch.setattr(StatsPrinter, "add_time_measure_ns", sink)
    with recording():
        with sp.measure_time("fetch frame"):
            with span("inside"):
                spin(0.001)
    (rec, inside) = records()
    assert (rec.name, rec.parent, inside.parent) == ("fetch frame", None, 0)
    assert seen[0][0] == "fetch frame"
    span_ns = round((rec.end - rec.start) * 1e9)
    assert 1e6 <= span_ns <= seen[0][1] < span_ns + 1e6
    assert sp._global.times_ns["fetch frame"].n == 1


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """The records of a short EVT3 replay through the app's pipe (packet
    ring on, every frame's inlier count read, no image fetched)."""
    calib = make_synthetic_calibration()
    events = simulate_sequence(calib, DEPTHS, fps=FPS, subsample=0.6,
                               rng=np.random.default_rng(0))
    path = tmp_path_factory.mktemp("trace") / "seq.raw"
    path.write_bytes(encode_evt3(events, calib.camera_width, calib.camera_height))
    engine = XMapsDepthEngine.from_calibration(calib, device="cpu", event_capacity=16384,
                                               z_near=0.2, z_far=1.2)
    params = RuntimeParams(
        camera_width=calib.camera_width, camera_height=calib.camera_height,
        projector_width=calib.projector_width, projector_height=calib.projector_height,
        projector_fps=FPS, z_near=0.2, z_far=1.2, calib="", no_frame_dropping=True)
    pipe = DepthReprojectionPipe(params, StatsPrinter(silent=True), frame_callback=None,
                                 engine=engine, frame_wanted=lambda: False)
    stats.clear()
    with recording():
        for packet in FileEventsIterator(str(path), delta_t=1e6 / FPS / 4):
            pipe.process_events(packet)
        pipe.flush()
    out = records()
    stats.clear()
    return out, pipe.stats_printer._global.counters


def test_replay_spans_nest_at_the_layer_boundaries(replay):
    recs, counters = replay
    packets = named(recs, "pipe.packet")
    assert [recs[i].tag for i in packets] == list(range(1, len(packets) + 1))
    assert all(recs[i].parent is None for i in packets)
    order = ["act+pol filter", "prestage packet", "trigger.scan"]
    for i in packets:
        kids = [recs[j].name for j in children(recs, i)]
        assert kids == [n for n in order if n in kids] and kids[0] == "act+pol filter"
    assert all(named(recs, n) for n in order)
    handovers = named(recs, "pipe.handover")
    assert len(handovers) == counters["trig ok"] == counters["frames dispatched"] >= 3
    assert [recs[i].tag for i in handovers] == list(range(1, len(handovers) + 1))
    for h in handovers:
        scan = recs[h].parent
        assert recs[scan].name == "trigger.scan" and recs[recs[scan].parent].name == "pipe.packet"
        kids = [recs[j].name for j in children(recs, h)]
        assert "ring.frame" in kids and "dispatch frame" in kids
        (dispatch,) = children(recs, h, "dispatch frame")
        assert [recs[j].name for j in children(recs, dispatch)] == ["engine.ring"]
    # every frame's count is read at the next handover or the final flush
    fetches = named(recs, "fetch stats")
    assert len(fetches) == len(handovers)
    assert recs[fetches[-1]].parent is None
    assert not named(recs, "kernel.launch")  # the CPU runs the plain versions
    scans = named(recs, "trigger.scan")
    assert len(scans) == counters["trig ok"] + counters.get("trig fail", 0)
    assert all(children(recs, s, "find pauses") for s in scans)


def test_source_spans_never_cover_the_consumer(replay):
    recs, _ = replay
    source = [r for r in recs if r.name in ("io.decode", "io.packetize")]
    assert {r.name for r in source} == {"io.decode", "io.packetize"}
    assert all(r.parent is None for r in source)
    packets = [r for r in recs if r.name == "pipe.packet"]
    for s in source:
        assert all(s.end <= p.start or s.start >= p.end for p in packets)


def test_stage_group_spans():
    calib = make_synthetic_calibration()
    engine = XMapsDepthEngine.from_calibration(calib, device="cpu", event_capacity=2048,
                                               z_near=0.2, z_far=1.2)
    rng = np.random.default_rng(3)
    frames = [simulate_plane_events(calib, depth_m=0.5 + 0.05 * i, subsample=0.3, rng=rng)
              for i in range(3)]
    with recording():
        staged = engine.stage_group(frames)
        group_depth_frames(staged, engine.tables, engine.cfg, engine.plan,
                           layout=engine.compact_layout, display_only=True,
                           display_packed=True)
        engine.set_frame_filter("first_per_xy")  # the 2-word staging
        engine.stage_group(frames)
    engine.set_frame_filter("none")
    recs = records()
    compact, two_word = named(recs, "engine.stage_group")
    assert [recs[j].name for j in children(recs, compact)] == [
        "staging.check", "staging.copy", "staging.pack", "staging.copy"]
    assert [recs[j].name for j in children(recs, two_word)] == ["staging.check", "staging.copy"]
    (group,) = named(recs, "engine.group")
    assert recs[group].parent is None and not children(recs, group)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_launch_spans_precede_their_kernels_on_card(card, tmp_path):
    """Under the benchmark's CUDA-only profiler session the tracer records,
    and each device kernel of an ESL group call starts after the start of the
    ``kernel.launch`` span that issued it: kernel 1's group entry one kernel
    a launch, the projector tail two (``tail_dilate``, ``tail_remap_colorize``).
    The device trace is tied to the host's clock at its first marker; the
    second marker's offset from its host time measures how far the two
    clocks drift apart over the window (tens of µs on an H100), and each
    kernel's time is corrected by that drift, pro rata, before the check.
    The marker kernel runs once before the session: the first launch of a
    kernel in a process loads its module, and a first marker that starts
    late places every device interval early by as much (200-320 µs).  Both
    corrections are this test's own: ``benchmark/devtrace.py`` makes
    neither, so the benchmark's readers place the device intervals that
    much early against the program's spans; this test checks the clock a
    corrected trace would have, not the one the benchmark uses."""
    from benchmark.devtrace import DeviceTrace
    from xmaps_tpu_torch.apps import bench_geometry

    calib = bench_geometry.rig("esl")
    engine = XMapsDepthEngine.from_calibration(
        calib, device="cuda", event_capacity=28 * 1024, z_near=0.2, z_far=1.2,
        xmap_cache_dir=str(tmp_path / "cache"))
    staged = engine.stage_group(bench_geometry.make_frames(calib, 12, 28 * 1024))

    def call():
        torch.cuda.synchronize(card)  # an idle card, as at the marker
        group_depth_frames(staged, engine.tables, engine.cfg, engine.plan,
                           layout=engine.compact_layout, display_only=True,
                           display_packed=True)

    call()
    torch.cuda._sleep(1000)
    trace = DeviceTrace(card)
    trace.start()
    for _ in range(20):
        call()
    stats.clear()
    marks = [trace.mark()]
    for _ in range(5):
        call()
    marks.append(trace.mark())
    trace.stop(marks)
    recs = records()
    assert len(named(recs, "engine.group")) == 5
    launches = {}
    for i in named(recs, "kernel.launch"):
        assert recs[recs[i].parent].name == "engine.group"
        launches.setdefault(recs[i].tag, []).append(recs[i].start * 1e6)
    assert sorted(launches) == ["event_disparity_scatter_group", "tail_projector_group"]
    drift = trace.window[1] - marks[1]

    def on_host(t):  # a device time in µs, less the drift so far
        return t - drift * (t - marks[0]) / (marks[1] - marks[0])

    margins = {}
    for tag, family, per_launch in (("event_disparity_scatter_group", "event_disparity_scatter", 1),
                                    ("tail_projector_group", "tail_", 2)):
        starts = sorted(s for n, s, _ in trace.events if family in n)
        assert len(starts) == per_launch * len(launches[tag]) == per_launch * 5
        margins[tag] = [round(on_host(s) - launches[tag][k // per_launch], 3)
                        for k, s in enumerate(starts)]
    print(f"\nµs from launch span to kernel start: {margins}; drift {drift:+.3f} µs")
    assert all(m > 0 for ms in margins.values() for m in ms), margins
