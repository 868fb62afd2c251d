"""A run of each cell on the tiny rig (the program's plain versions on the
CPU): the result line's keys, its comparison, the control and the faults
it must catch, and that the run loads nothing of JAX."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import devtrace, harness
from benchmark.tests.conftest import DATA, ROOT

CELLS = ["demo-live-projector", "esl-resident-projector", "demo-replay-projector",
         "demo-batch-camera"]
SEED = 2**31 + 12345


def run(spec, cell, cache_dir, seconds=1.5):
    """One run on the CPU; a stream's window long enough that the seed's
    sample holds frames the trigger finder hands over at 60 Hz."""
    return harness.run_cell(spec, cell, SEED, seconds, False, "cpu", root=DATA,
                            cache_dir=cache_dir)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny_spec, cache_dir, cell):
    out = run(tiny_spec, cell, cache_dir)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["attempted"] > 0
    e2e = {m["name"]: m["unit"] for m in harness.cell_metrics(tiny_spec, cell, "end_to_end")}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == e2e
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c == {"value": 0, "limit": 0} for c in out["checks"].values())
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_spec, cache_dir, cell):
    from benchmark import control

    r = control.readings(tiny_spec, cell, SEED, 1.5, "cpu", root=DATA, cache_dir=cache_dir)
    assert not harness.checks_ok(r["control"]) and r["control"]["pixels_off"]["value"] > 0
    assert harness.checks_ok(r["program"])


def _stale(orig):
    """The entry returning its first result again: a step that leaves its
    state unchanged."""
    first = []

    def call(self, *a, **kw):
        res = orig(self, *a, **kw)
        first.append(res)
        return first[0]
    return call


def _altered(orig):
    """The entry's result with one answer altered where it is produced."""
    def call(self, *a, **kw):
        res = orig(self, *a, **kw)
        for r in res if isinstance(res, list) else [res]:
            r.frame_bgr.view(-1)[r.frame_bgr.numel() // 2] ^= 0x10101
        return res
    return call


def _half(orig):
    """Staging that leaves out half of each frame's events."""
    def call(self, frames, **kw):
        return orig(self, [f[: len(f) // 2] for f in frames], **kw)
    return call


FAULTS = {
    ("demo-live-projector", "stale"): ("process_ring", _stale),
    ("demo-live-projector", "altered"): ("process_ring", _altered),
    ("demo-replay-projector", "stale"): ("process_ring", _stale),
    ("demo-replay-projector", "altered"): ("process_ring", _altered),
    ("demo-batch-camera", "altered"): ("process_frames", _altered),
    ("demo-batch-camera", "half"): ("stage_group", _half),
    ("esl-resident-projector", "half"): ("stage_group", _half),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS), ids=lambda x: str(x))
def test_fault_is_not_correct(tiny_spec, cache_dir, monkeypatch, cell, fault):
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine

    name, make = FAULTS[(cell, fault)]
    monkeypatch.setattr(XMapsDepthEngine, name, make(getattr(XMapsDepthEngine, name)))
    assert run(tiny_spec, cell, cache_dir)["correct"] is False


def _stalled(orig):
    """The entry taking longer than a projector period now and then."""
    calls = []

    def call(self, *a, **kw):
        calls.append(None)
        if len(calls) % 7 == 0:
            time.sleep(0.03)
        return orig(self, *a, **kw)
    return call


@pytest.mark.parametrize("cell", ["demo-live-projector", "demo-replay-projector"])
def test_failed_follows_the_events_not_the_clock(tiny_spec, cache_dir, monkeypatch, cell):
    """A frame that is late is late, not failed: a seed fails the same
    frames however the host stalls, so two runs of one seed agree."""
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine

    steady = run(tiny_spec, cell, cache_dir)
    monkeypatch.setattr(XMapsDepthEngine, "process_ring",
                        _stalled(XMapsDepthEngine.process_ring))
    stalled = run(tiny_spec, cell, cache_dir)
    assert steady["correct"] is True and stalled["correct"] is True
    if cell == "demo-live-projector":
        assert (stalled["attempted"], stalled["failed"]) == (steady["attempted"], steady["failed"])
        assert 0 < steady["failed"] < steady["attempted"]
    else:
        assert steady["failed"] == stalled["failed"] == 0


def test_resident_answer_altered(tiny_spec, cache_dir, monkeypatch):
    import xmaps_tpu_torch.ops.frame_pipeline as fp

    orig = fp.group_depth_frames

    def altered(*a, **kw):
        res = orig(*a, **kw)
        res.frame_bgr[-1].view(-1)[7] ^= 0x10101
        return res
    monkeypatch.setattr(fp, "group_depth_frames", altered)
    assert run(tiny_spec, "esl-resident-projector", cache_dir)["correct"] is False


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "xmaps_tpu_torch.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    found = harness.forbidden_modules()
    assert "xmaps_tpu" not in found and "jaxlike" not in found
    monkeypatch.setitem(sys.modules, "xmaps_tpu.ops", sys)
    assert "xmaps_tpu" in harness.forbidden_modules()


@pytest.mark.parametrize("cell", ["demo-replay-projector", "demo-batch-camera"])
def test_a_run_loads_nothing_of_jax(tiny_spec, cache_dir, tmp_path, cell):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(tiny_spec))
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "spec = harness.load_spec(%r)\n"
        "out = harness.run_cell(spec, %r, 5, 0.2, False, 'cpu', root=%r, cache_dir=%r)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (ROOT, str(spec), cell, DATA, cache_dir)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "xmaps_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "xmaps_tpu"}


def test_device_trace_reduction():
    tr = devtrace.DeviceTrace("cpu")
    tr.window = (0.0, 100.0)
    tr.events = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("k1", 50.0, 60.0), ("k3", 95.0, 120.0)]
    assert tr.busy_intervals() == [[10.0, 30.0], [50.0, 60.0], [95.0, 100.0]]
    assert tr.busy_s() == pytest.approx(35e-6)
    assert tr.kernel_seconds(["k1"]) == pytest.approx(20e-6)
    assert tr.top_ops(2) == [["k3", pytest.approx(25e-6)], ["k1", pytest.approx(20e-6)]]
    spans = [("pace.wait", 30e-6, 50e-6, None), ("engine.process_ring", 60e-6, 70e-6, None)]
    assert tr.idle_gaps(spans) == [["engine.process_ring", pytest.approx(35e-6)],
                                   ["pace.wait", pytest.approx(20e-6)],
                                   ["host", pytest.approx(10e-6)]]


@pytest.mark.gpu
def test_control_fails_at_the_cells_size(card):
    """On the card: the control fails every cell at its own size."""
    from benchmark import control

    spec = harness.load_spec()
    for cell in CELLS:
        r = control.readings(spec, cell, SEED, 1.0, card)
        assert all(c["value"] == 0 for c in r["program"].values())
        assert r["control"]["pixels_off"]["value"] > 0
        torch.cuda.empty_cache()
