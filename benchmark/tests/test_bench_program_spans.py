"""The readers of the program's own spans (``benchmark/metrics/``, source
``program_span``) against hand-made records and runs: each reads what its
docstring says, keeps to the run's window, and gives None where the spans
are missing or the program has no tracer."""

import types

import pytest

from benchmark import devtrace, harness
from xmaps_tpu_torch.utils import stats
from xmaps_tpu_torch.utils.stats import Record

NEW = ["runtime.filter_us.live", "ring.stage_us.live", "trigger.scan_us.live",
       "io.source_us.replay", "device.idle_in_source_share.replay",
       "staging.check_us_per_frame.batch", "staging.pack_us_per_frame.batch",
       "staging.copy_us_per_frame.batch", "engine.launch_us.group", "engine.glue_us.group",
       "engine.ring_us.live", "ring.frame_us.live", "staging.group_us_per_frame.batch"]


class Recs:
    """Records built in order: ``add`` returns the new record's index."""

    def __init__(self):
        self.recs = []

    def add(self, name, start, end, parent=None, tag=None):
        self.recs.append(Record(name, start, end, parent, tag))
        return len(self.recs) - 1


def make_run(window=(1.0, 2.0), values=None, trace=None):
    return types.SimpleNamespace(window=window, values=values or {}, trace=trace)


def read(name, run, recs, monkeypatch):
    monkeypatch.setattr(stats, "records", lambda: list(recs.recs))
    return harness.reader(name)(run)


def live_records():
    """Two triggering packets in the window, one that triggers nothing, and
    one triggering packet before the window."""
    r = Recs()
    for t0, filt, stage, scan, handover in ((0.5, 9e-6, 9e-6, 9e-6, 9e-6),
                                            (1.1, 10e-6, 20e-6, 100e-6, 40e-6),
                                            (1.2, 1e-6, 1e-6, 1e-6, None),
                                            (1.3, 30e-6, 40e-6, 300e-6, 80e-6)):
        p = r.add("pipe.packet", t0, t0 + 0.01, tag=t0)
        t = t0
        for name, d in (("act+pol filter", filt), ("prestage packet", stage)):
            r.add(name, t, t + d, p)
            t += d
        s = r.add("trigger.scan", t, t + scan, p)
        r.add("find pauses", t, t + 1e-6, s)
        if handover is not None:
            h = r.add("pipe.handover", t + 2e-6, t + 2e-6 + handover, s)
            r.add("ring.frame", t + 2e-6, t + 2e-6 + handover / 4, h)
            d = r.add("dispatch frame", t + 3e-6, t + 3e-6 + handover / 2, h)
            r.add("engine.ring", t + 3e-6, t + 3e-6 + handover / 2, d)
        r.add("trig ok", t + scan, t + scan, p, 1)
    return r


@pytest.mark.parametrize("name, want", [("runtime.filter_us.live", 20.0),
                                        ("ring.stage_us.live", 30.0),
                                        ("trigger.scan_us.live", 140.0),
                                        ("ring.frame_us.live", 15.0),
                                        ("engine.ring_us.live", 30.0)])
def test_live_readers_median_over_triggering_packets(monkeypatch, name, want):
    # scan less its handover: 100 - 40 = 60 and 300 - 80 = 220, median 140;
    # the handover's ring.frame a quarter of it (10, 20), engine.ring a half (20, 40)
    assert read(name, make_run(), live_records(), monkeypatch) == pytest.approx(want)


def test_replay_source_over_packets(monkeypatch):
    r = Recs()
    r.add("io.decode", 0.9, 0.95)  # before the window
    r.add("io.decode", 1.0, 1.03)
    r.add("io.packetize", 1.03, 1.031)
    for k in range(4):
        r.add("pipe.packet", 1.1 + 0.1 * k, 1.15 + 0.1 * k)
    r.add("io.packetize", 1.5, 1.509)
    r.add("pipe.packet", 2.5, 2.6)  # after it
    assert read("io.source_us.replay", make_run(), r, monkeypatch) == pytest.approx(10_000.0)


def test_idle_in_source_share(monkeypatch):
    tr = devtrace.DeviceTrace("cpu")
    tr.window = (1_000_000.0, 1_100_000.0)  # µs, as the trace keeps them
    tr.events = [("k", 1_010_000.0, 1_020_000.0), ("k", 1_050_000.0, 1_070_000.0)]
    r = Recs()
    r.add("io.decode", 1.000, 1.015)  # 10 ms idle inside, 5 ms busy
    r.add("io.packetize", 1.030, 1.040)  # 10 ms idle
    r.add("io.decode", 1.095, 1.2)  # 5 ms idle inside the trace window
    r.add("pipe.packet", 1.040, 1.050)
    got = read("device.idle_in_source_share.replay", make_run(trace=tr), r, monkeypatch)
    assert got == pytest.approx(100.0 * 25 / 70)


def test_staging_split_per_frame(monkeypatch):
    r = Recs()
    for t0 in (1.0, 1.5, 2.5):  # the last group after the window
        g = r.add("engine.stage_group", t0, t0 + 0.1)
        r.add("staging.check", t0, t0 + 0.001, g)
        r.add("staging.copy", t0 + 0.001, t0 + 0.002, g)
        r.add("staging.pack", t0 + 0.002, t0 + 0.092, g)
        r.add("staging.copy", t0 + 0.092, t0 + 0.095, g)
    run = make_run(values={"frames": 24})
    got = {k: read(f"staging.{k}_us_per_frame.batch", run, r, monkeypatch)
           for k in ("check", "pack", "copy", "group")}
    assert got == pytest.approx({"check": 2e3 / 24, "pack": 180e3 / 24, "copy": 8e3 / 24,
                                 "group": 200e3 / 24})


def test_group_launch_and_glue(monkeypatch):
    r = Recs()
    for t0 in (1.0, 1.1):
        g = r.add("engine.group", t0, t0 + 160e-6)
        r.add("kernel.launch", t0 + 10e-6, t0 + 20e-6, g, "event_disparity_scatter_group")
        r.add("kernel.launch", t0 + 100e-6, t0 + 130e-6, g, "tail_projector_group")
    r.add("engine.group", 2.1, 2.2)  # after the window
    run = make_run()
    launch = read("engine.launch_us.group", run, r, monkeypatch)
    glue = read("engine.glue_us.group", run, r, monkeypatch)
    assert (launch, glue) == (pytest.approx(40.0), pytest.approx(120.0))


@pytest.mark.parametrize("name", NEW)
def test_none_without_spans(monkeypatch, name):
    tr = devtrace.DeviceTrace("cpu")
    tr.window, tr.events = (1e6, 2e6), []
    run = make_run(values={"frames": 12}, trace=tr)
    r = Recs()
    r.add("unrelated", 1.1, 1.2)
    assert read(name, run, r, monkeypatch) is None
    assert read(name, run, Recs(), monkeypatch) is None


@pytest.mark.parametrize("name", NEW)
def test_none_from_a_program_without_the_tracer(monkeypatch, name):
    """The parent commit's program has no ``records``: the reader gives
    None and does not raise."""
    monkeypatch.delattr(stats, "records")
    assert harness.reader(name)(make_run(values={"frames": 12})) is None


def test_new_metrics_read_program_spans():
    spec = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    assert all(spec[n]["source"] == "program_span" and spec[n]["workloads"] for n in NEW)
