"""The port's measurement tools (``xmaps_tpu_torch.apps.profile_setup``,
``check_bitexact``, ``profile_trace``, ``profile_stages``, ``bench_esl_init``,
``profile_esl_init``) and the engine's ``setup_timings`` on the CPU.

Each tool runs in a fresh interpreter with ``--device cpu`` on a small rig,
prints its JSON contract and loads nothing of JAX; ``check_bitexact``'s
entries are held bit for bit against the JAX engine's plain path
(``use_pallas_events=False, use_pallas_tail=False``) on the same events,
duplicates included; ``profile_trace``'s bucketing is checked on a made-up
trace, since the CPU has no CUDA events.  The card runs are in
``tests/test_torch_cuda.py`` (marked ``gpu``).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration as jax_calibration  # noqa: E402
from xmaps_tpu.utils.synthetic import simulate_plane_events as jax_plane_events  # noqa: E402

from xmaps_tpu_torch.apps import (  # noqa: E402
    bench_esl_init,
    check_bitexact,
    profile_esl_init,
    profile_setup,
    profile_stages,
    profile_trace,
)
from xmaps_tpu_torch.apps.make_demo_data import write_xmaps_yaml  # noqa: E402
from xmaps_tpu_torch.apps.measure import call_spans, tool_rig  # noqa: E402
from xmaps_tpu_torch.config import RuntimeParams  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine as TEngine  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CAMERA, PROJECTOR = (96, 72), (64, 96)
RIG = ["--camera", "96", "72", "--projector", "64", "96"]
ESL_RIG = ["--camera", "96", "72", "--projector", "45", "80"]
LABELS = [
    "device resolved (kernel library built or loaded)",
    "CamProjMaps (host calibration math, disk-cached)",
    "X-map build/load",
    "DeviceTables H2D",
    "kernel plans built (tail plan, colorize table)",
    "engine assembled",
]
DEPTHS = (0.35, 0.6, 1.0)
EVENTS = 2048

#: tool -> (its arguments on the CPU, the keys its JSON line must hold)
TOOLS = {
    "profile_setup": (RIG, ("import_torch_s", "backend_init_s", "first_tiny_put_s",
                            "first_32mb_put_s", "first_1mb_get_s", "kernel_library_s",
                            "first_kernel_program_s", "engine_build1_s", "engine_build2_s",
                            "engine_build1_steps", "engine_build2_steps", "first_frame_s",
                            "frame_run_s", "first_group12_s", "group12_run_s", "gpu",
                            "power_limit_w")),
    "check_bitexact": (["--geometry", "both", "--events", str(EVENTS), "--depths", "0.5"] + RIG,
                       ("value", "cases", "entries")),
    "profile_trace": (["--frames", "2"] + RIG,
                      ("event_kernel_us", "scatter_us", "tail_kernel_us", "outside_kernels_us",
                       "device_ops_total_us", "module_total_us", "classification_ok",
                       "ops_per_frame", "significant_ops_per_frame", "busy_share")),
    "profile_stages": (["--frames", "2", "--rounds", "1", "2"] + RIG,
                       ("event_us", "scatter_us", "event_scatter_us", "full_us",
                        "tail_only_us", "glue_us")),
    "bench_esl_init": (ESL_RIG, ("value", "unit", "vs_cuda_18_99ms", "composed_remap_ms",
                                 "full_surface_ms", "footprint_rows", "footprint_cols",
                                 "footprint_area_frac", "bit_equal_to_full", "geometry",
                                 "calib", "gpu", "power_limit_w")),
    "profile_esl_init": (ESL_RIG, ("module_ms", "ops_total_ms", "top", "calib")),
}
METRICS = {"profile_setup": "setup_breakdown_s", "check_bitexact": "bitexact_failures",
           "profile_trace": "device_stage_budget_us_per_frame",
           "profile_stages": "stage_us_per_frame", "bench_esl_init": "esl_init_ms_per_scan",
           "profile_esl_init": "esl_init_op_attribution_ms_per_scan"}


def _run_tool(name, argv, tmp_path, env=()):
    """(the tool's JSON line, the JAX modules loaded after it ran) from a
    fresh interpreter with ``HOME`` at ``tmp_path``."""
    code = f"""
import json, sys
from xmaps_tpu_torch.apps import {name} as tool
rc = tool.main({argv!r})
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "xmaps_tpu"))
print(json.dumps({{"rc": rc, "loaded": loaded}}))
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=240, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path), **dict(env)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    tail = json.loads(lines[-1])
    assert tail["rc"] == 0
    return json.loads(lines[-2]), tail["loaded"]


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_the_cpu_without_jax(name, tmp_path):
    """The tool on the CPU at a small rig: its one JSON line with the JAX
    script's keys, the device named, no card's number, nothing of JAX."""
    argv, keys = TOOLS[name]
    doc, loaded = _run_tool(name, ["--device", "cpu"] + argv, tmp_path)
    assert loaded == []
    assert doc["metric"] == METRICS[name] and doc["device"] == "cpu"
    for key in keys:
        assert key in doc, key
    assert doc.get("gpu") is None and doc.get("power_limit_w") is None
    if name == "check_bitexact":
        assert doc["value"] == 0 and doc["cases"] == 4 and doc["geometries"] == ["demo", "esl"]
    elif name == "profile_trace":
        assert doc["classification_ok"] is False and doc["busy_share"] is None
        assert set(doc["ops_per_frame"]) == set(doc["significant_ops_per_frame"]) == {
            "event_kernel", "scatter", "tail_kernel", "other"}
    elif name == "profile_stages":
        assert doc["event_us"] is None and doc["scatter_us"] is None
        assert doc["full_us"] > 0 and doc["clock"] == "host"
    elif name == "profile_setup":
        assert list(doc["engine_build1_steps"]) == LABELS and doc["kernel_library_s"] is None
        assert doc["engine_build1_s"] >= sum(doc["engine_build1_steps"].values())
    elif name == "bench_esl_init":
        assert doc["bit_equal_to_full"] is True and doc["calib"] == "synthetic ESL rig"
        assert doc["geometry"] == "96x72 cam, 45x80 proj, 135x240 rect"
        assert doc["value"] > 0 and doc["nonzero_disparities"] > 0
    elif name == "profile_esl_init":
        assert doc["ops_total_ms"] > 0 and doc["clock"].startswith("host")


def test_profile_setup_cold_uses_fresh_directories(tmp_path):
    """``XMAPS_SETUP_COLD=1``: the caches at fresh temporary directories,
    nothing written under ``HOME``'s cache, the build 1 X-map built."""
    doc, _ = _run_tool("profile_setup", ["--device", "cpu"] + RIG, tmp_path,
                       env={"XMAPS_SETUP_COLD": "1"})
    assert doc["cold_caches"] is True
    assert not (tmp_path / ".cache" / "xmaps_tpu_torch").exists()
    steps1, steps2 = doc["engine_build1_steps"], doc["engine_build2_steps"]
    assert list(steps2) == LABELS and steps2["X-map build/load"] < steps1["X-map build/load"]


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_refuses_cuda_without_a_card(name, monkeypatch):
    """``--device cuda`` (the default) without a card raises: no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = globals()[name].main
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--device", "cuda"] + TOOLS[name][0])


# -- the engine's setup timings --------------------------------------------

def test_setup_timings_labels_and_wall(tmp_path, monkeypatch, capsys):
    """``from_calibration`` marks the six steps in order, their sum within
    the build's wall; ``XMAPS_SETUP_TRACE=1`` prints each mark to stderr;
    ``to`` and ``from_runtime_params`` keep the list."""
    import time

    calib = tool_rig("demo", CAMERA, PROJECTOR)
    monkeypatch.setenv("XMAPS_SETUP_TRACE", "1")
    t0 = time.perf_counter()
    eng = TEngine.from_calibration(calib, device="cpu", event_capacity=EVENTS,
                                   xmap_cache_dir=str(tmp_path))
    wall = time.perf_counter() - t0
    labels = [label for label, _ in eng.setup_timings]
    assert labels == LABELS
    assert all(dt >= 0 for _, dt in eng.setup_timings)
    assert sum(dt for _, dt in eng.setup_timings) <= wall
    err = capsys.readouterr().err.splitlines()
    assert [line.split("] ", 1)[1] for line in err if line.startswith("[setup +")] == LABELS
    assert eng.to("cpu").setup_timings == eng.setup_timings
    yaml_path = str(tmp_path / "calib.yaml")
    write_xmaps_yaml(yaml_path, calib)
    params = RuntimeParams(camera_width=CAMERA[0], camera_height=CAMERA[1],
                           projector_width=PROJECTOR[0], projector_height=PROJECTOR[1],
                           projector_fps=60, z_near=0.2, z_far=1.2, calib=yaml_path)
    monkeypatch.delenv("XMAPS_SETUP_TRACE")
    eng2 = TEngine.from_runtime_params(params, device="cpu", xmap_cache_dir=str(tmp_path))
    assert [label for label, _ in eng2.setup_timings] == LABELS
    assert not capsys.readouterr().err


# -- check_bitexact against the JAX engine ---------------------------------

def _jax_case_events(calib, depths, events):
    """The JAX script's events (``eval/check_bitexact.py:84-93``), restated
    on ``xmaps_tpu.utils.synthetic``."""
    rng = np.random.default_rng(11)
    out = []
    for d in depths:
        ev = jax_plane_events(calib, depth_m=d, subsample=0.031, jitter_us=2.0, rng=rng)
        out.append(np.concatenate([ev, ev[::7]])[: events - 512])
    return out


@functools.lru_cache(maxsize=None)
def _engines(view):
    kw = dict(event_capacity=EVENTS, z_near=0.2, z_far=1.2, camera_perspective=view)
    jcal = jax_calibration(camera_width=CAMERA[0], camera_height=CAMERA[1],
                           projector_width=PROJECTOR[0], projector_height=PROJECTOR[1])
    jeng = JEngine.from_calibration(jcal, use_pallas_events=False, use_pallas_tail=False, **kw)
    teng = TEngine.from_calibration(tool_rig("demo", CAMERA, PROJECTOR), device="cpu", **kw)
    return jcal, jeng, teng


def test_case_events_equal_the_jax_scripts():
    """The sweep's events, field by field, equal to the JAX script's, with
    the duplicated stride: many lanes share a target pixel."""
    jcal, _, _ = _engines(False)
    got = check_bitexact.case_events(tool_rig("demo", CAMERA, PROJECTOR), DEPTHS, EVENTS)
    want = _jax_case_events(jcal, DEPTHS, EVENTS)
    for a, b in zip(got, want, strict=True):
        for name in b.dtype.names:
            np.testing.assert_array_equal(a[name], b[name])
        xy = a["y"].astype(np.int64) * CAMERA[0] + a["x"]
        assert len(np.unique(xy)) < len(xy) - len(a) // 8


@pytest.mark.parametrize("view", [False, True], ids=["projector", "camera"])
def test_entries_equal_the_jax_plain_path(view):
    """Each of the four entries (``process_frame``, display-packed,
    ``process_staged`` 1-word, ``process_frames`` of the 3 depths) on the
    CPU port, bit for bit against the JAX engine's ``process_frame`` on its
    XLA path, duplicates and all."""
    jcal, jeng, teng = _engines(view)
    frames = _jax_case_events(jcal, DEPTHS, EVENTS)
    assert teng.compact_layout is not None
    entries = check_bitexact.run_entries(teng, frames)
    for ev, got in zip(frames, entries, strict=True):
        assert list(got) == list(check_bitexact.ENTRIES)
        ref = jeng.process_frame(ev)
        want = {f: np.asarray(getattr(ref, f)) for f in check_bitexact.FIELDS}
        assert check_bitexact.mismatches(got, want) == []
        assert int(want["num_inliers"]) > 0
        assert got["process_staged"]["depth"] is None


def test_mismatches_names_the_entry_and_field():
    """One element off, or a dtype changed, is a mismatch of that entry and
    field; a field an entry does not emit is skipped."""
    _, _, teng = _engines(False)
    frames = check_bitexact.case_events(tool_rig("demo", CAMERA, PROJECTOR), DEPTHS[:1], EVENTS)
    (got,) = check_bitexact.run_entries(teng, frames)
    ref = {k: v.copy() for k, v in got["process_frame"].items()}
    assert check_bitexact.mismatches(got, ref) == []
    ref["depth"].flat[np.argmax(ref["depth"])] += 1e-3
    ref["num_inliers"] = ref["num_inliers"].astype(np.int64)
    assert check_bitexact.mismatches(got, ref) == [
        "process_frame depth", "process_frame num_inliers", "display_packed num_inliers",
        "process_staged num_inliers", "process_frames depth", "process_frames num_inliers"]


def test_check_bitexact_main_counts_failures(monkeypatch, tmp_path, capsys):
    """A case whose entry mismatches is counted, printed, and fails the run."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(check_bitexact, "mismatches", lambda got, ref: ["process_staged depth"])
    rc = check_bitexact.main(["--device", "cpu", "--geometry", "demo", "--events", str(EVENTS),
                              "--depths", "0.5"] + RIG)
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and json.loads(lines[-1])["value"] == 2
    assert sum(line.startswith("MISMATCH demo") for line in lines) == 2


# -- profile_trace's bucketing -----------------------------------------------

def _trace(tail_names, calls=3, frames=12):
    """A made-up window of ``calls`` group calls: kernel 1's group entry and
    the tail's kernels, each call after the last."""
    events, t = [], 0.0
    for _ in range(calls):
        for name, dur in [("void (anonymous namespace)::event_disparity_scatter_kernel<A>(B)",
                           20.0)] + [(n, 15.0) for n in tail_names]:
            events.append((name, t, dur))
            t += dur + 1.0
        t += 50.0
    return events


@pytest.mark.parametrize("view", ["projector", "camera"])
def test_budget_buckets_the_kernels(view):
    """The budget of a group's trace: each kernel in its bucket, the counts
    equal to the launches (kernel 2 two kernels a launch), the call spans
    and the busy share from the events."""
    if view == "projector":
        names = ["void tail_dilate_kernel(short const*)", "void tail_remap_colorize_kernel()"]
        launches = {"event_disparity_scatter_group": 3, "tail_projector_group": 3}
    else:
        names = ["void colorize_camera_kernel(int const*)"]
        launches = {"event_disparity_scatter_group": 3, "colorize_camera_group": 3}
    events = _trace(names)
    doc = profile_trace.budget(events, 36, launches)
    assert doc["classification_ok"] is True and doc["scatter_us"] == 0.0
    assert doc["event_kernel_us"] == pytest.approx(3 * 20.0 / 36)
    assert doc["tail_kernel_us"] == pytest.approx(3 * 15.0 * len(names) / 36)
    assert doc["outside_kernels_us"] == 0.0
    span = 20.0 + 1.0 + 16.0 * len(names) - 1.0
    assert call_spans(events, 3) == [span] * 3
    assert doc["module_total_us"] == pytest.approx(3 * span / 36)
    assert doc["busy_share"] == pytest.approx((20.0 + 15.0 * len(names)) / span)
    assert doc["significant_ops_per_frame"]["event_kernel"] == pytest.approx(3 / 36)
    # a lost tail kernel, or launches that do not match, fail the check
    short = [e for e in events if e[0] != names[-1]]
    assert profile_trace.budget(short, 36, launches)["classification_ok"] is False
    more = dict(launches, event_disparity_scatter_group=4)
    assert profile_trace.budget(events, 36, more)["classification_ok"] is False
    assert profile_trace.budget([], 36, {})["classification_ok"] is False


def test_classify_and_spans_refuse_a_ragged_window():
    """Names outside the three kernels are ``other``; events that do not
    split evenly into the calls raise."""
    assert profile_trace.classify("void at::native::vectorized_elementwise_kernel<4>") == "other"
    assert profile_trace.classify("Memcpy HtoD (Pinned -> Device)") == "other"
    assert profile_trace.classify("void colorize_camera_kernel()") == "tail_kernel"
    with pytest.raises(ValueError, match="split"):
        call_spans([("a", 0.0, 1.0)] * 4, 3)
