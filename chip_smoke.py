#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (xmaps_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Builds the seven CUDA kernels from xmaps_tpu_torch/csrc/ with nvcc (one
process a source, started together), checks each against its plain PyTorch
version on the card, and drives the port's paths:

- the per-frame engine (XMapsDepthEngine.from_calibration -> process_frame)
  at the paper's demonstrator geometry in both views and at the ESL bench
  geometry (phases 3-6), every frame checked bit for bit against the port
  on the CPU with the same tables;
- the five dedup frame filters (phase 5b): kernel 1 with each filter's
  scatter priority against its plain version, then ``set_frame_filter``
  and the 12 demonstrator frames in both views for each of the four dedup
  filters, and ``first_per_yt`` (the largest key space) on 3 frames at the
  ESL geometry, every frame bit-equal to the CPU port; phase 6 times each
  filter (wall and device ms a frame, the filter ops' device time);
- the offline evaluation at the ESL geometry (phase 7): the four eval apps
  (ESL init + refine, MC3D, X-maps, table) through their ``main`` on 4
  synthetic plane scans, with kernels A and B (ESL search, static remap)
  held against their plain versions and the brute force, and the outputs
  against the port on the CPU;
- the streaming replay app (phase 8): ``apps.depth_reprojection.main`` on a
  60-frame EVT3 recording of the demonstrator rig (1 s at 60 Hz, ~28k
  events a frame, blanking gaps), in both views, every frame the pipe
  computed checked bit for bit against the CPU port's ``process_staged``
  of the same segmented events, and the 2-word staging against the 1-word
  one on the card; one replay with a dedup filter selected through the
  processor's E key (2-word staging); then trigger -> frame-ready latency,
  replay frames/s, ingest Mev/s, the pinned H2D time and the busy share;
  then live capture: the app without ``--input`` on the wall-clock-paced
  ``synthetic`` camera for about 1 s each, with the PNG file sink (by
  default and with ``--low-latency``) and headless, every computed frame
  bit-equal to the CPU port, at least as many frames as the watchdog lets
  through at the run's measured host cost (``live_frame_floor``), with the
  trigger -> frame-ready latency, the stream lag and the host's stage
  timers under a paced stream;
- the engine benchmark (phase 9): kernel W (the warm-up) against its plain
  version, then one run of ``apps.bench``, whose JSON line is printed;
- the scatter-store micro-benchmark (phase 10): kernel S (last-write-wins
  stores into one tile) against its plain version, then one run of
  ``apps.bench_store_loop``, whose JSON line is printed and gives kernel
  S's times (kernel, plain version, ``index_put_``).

It times frames, scans and kernels (torch.profiler device time and wall
time) and prints one JSON line with every kernel's launches on the main
paths, error, time, plain and library time and bound, then the card's name
and power limit, then a last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any mismatch or error raises: there is no fallback and no caught phase.

Tolerances: every integer, u8 and float32 output is compared exactly
(max_abs_err must be 0), except the ESL refinement and its filters against
the CPU port: the refined depths may differ in at most 2% of the pixels,
each within its search bounds, and the filtered ones by at most 1e-3 m
(``exp`` differs between the card and the host).  The plausibility bounds
are the recovered plane depth, within 5% of the simulated plane (10% for
MC3D, whose disparities are a third as fine).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

KERNEL_INFO = {
    "event_disparity_scatter": (
        "xmaps_tpu_torch/csrc/events.cu",
        "xmaps_tpu/ops/pallas_events.py:508",
    ),
    "tail_projector": (
        "xmaps_tpu_torch/csrc/tail.cu",
        "xmaps_tpu/ops/pallas_tail.py:851",
    ),
    "colorize_camera": (
        "xmaps_tpu_torch/csrc/tail.cu",
        "xmaps_tpu/ops/pallas_tail.py:777",
    ),
    "esl_disparity_search": (
        "xmaps_tpu_torch/csrc/esl.cu",
        "xmaps_tpu/ops/pallas_esl.py:281",
    ),
    "remap_gather": (
        "xmaps_tpu_torch/csrc/remap.cu",
        "xmaps_tpu/ops/pallas_remap.py:411",
    ),
    "warmup_add_one": (
        "xmaps_tpu_torch/csrc/warmup.cu",
        "bench.py:97",
    ),
    "tile_store_last": (
        "xmaps_tpu_torch/csrc/store_loop.cu",
        "eval/bench_store_loop.py:86",
    ),
}
#: H100 SXM memory rate (NVIDIA data sheet), bytes/s: every kernel here
#: moves far more bytes than it does operations, so its bound is bytes
HBM_BYTES_PER_S = 3.35e12
N_FRAMES = 12
CAPACITY = 28 * 1024
Z_NEAR, Z_FAR = 0.2, 1.2
#: phase 7: camera / projector of the ESL eval apps' defaults, and the
#: rectified disparities (p03 / z, in [5, 900)) of the simulated planes
ESL_CAM = (640, 480)
ESL_PROJ = (1080, 1920)
ESL_DISPARITIES = (180, 220, 260, 300)
#: phase 8: frames of the replayed recording (1 s at 60 Hz)
STREAM_FRAMES = 60
#: phase 8: seconds of each live-capture run
LIVE_S = 1.0


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a, b) -> float:
    """Max |a - b| over two tensors (or None pairs); raises on a shape or
    dtype mismatch."""
    if a is None and b is None:
        return 0.0
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {a.shape} {a.dtype} != {b.shape} {b.dtype}")
    a = a.detach().cpu()
    b = b.detach().cpu()
    if a.numel() == 0:
        return 0.0
    if a.is_floating_point():
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return float("inf")
        return float((a.double() - b.double()).abs().max())
    return float((a.long() - b.long()).abs().max())


def assert_exact(what: str, pairs) -> float:
    err = max(max_abs_err(a, b) for a, b in pairs)
    if err != 0.0:
        raise AssertionError(f"{what}: max_abs_err {err} (exact match required)")
    return err


def make_frames(calib, n, subsample, rng_seed=7, target=None):
    from xmaps_tpu_torch.utils.synthetic import simulate_plane_events

    rng = np.random.default_rng(rng_seed)
    frames = []
    for i in range(n):
        ev = simulate_plane_events(
            calib, depth_m=0.45 + 0.02 * i, subsample=subsample,
            jitter_us=2.0, rng=rng,
        )
        if target is not None and len(ev) > target:
            ev = ev[np.sort(rng.choice(len(ev), size=target, replace=False))]
        frames.append(ev)
    return frames


def frame_pairs(a, b):
    return [
        (a.frame_bgr, b.frame_bgr), (a.depth, b.depth),
        (a.disp_map, b.disp_map), (a.num_inliers, b.num_inliers),
    ]


def view_kwargs(eng):
    """(kernel 1's view arguments, the tail kernel, its plain version, its
    name) of the engine's view."""
    from xmaps_tpu_torch.ops.cuda_tail import (
        colorize_camera,
        colorize_camera_plain,
        tail_projector,
        tail_projector_plain,
    )

    cfg, plan = eng.cfg, eng.plan
    if cfg.camera_perspective:
        kw = dict(camera_view=True, window=(0, 0),
                  out_shape=(cfg.camera_height, cfg.camera_width))
        return kw, colorize_camera, colorize_camera_plain, "colorize_camera"
    kw = dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
              out_shape=(plan.H, plan.W))
    return kw, tail_projector, tail_projector_plain, "tail_projector"


def kernel_parity(eng, ev, errs):
    """Phase 3: each kernel against its plain version on the card, on the
    shapes the engine's main path gives it."""
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter,
        event_disparity_scatter_plain,
    )
    from xmaps_tpu_torch.ops.disparity import scale_time

    cfg, plan, tables = eng.cfg, eng.plan, eng.tables
    batch = eng.make_batch(ev)
    t_bin = scale_time(batch.t, batch.valid, cfg.t_px_scale)
    kw, tail, tail_plain, tail_name = view_kwargs(eng)
    got = event_disparity_scatter(batch, t_bin, tables, want_lanes=True, **kw)
    ref = event_disparity_scatter_plain(batch, t_bin, tables, want_lanes=True, **kw)
    err = assert_exact(
        f"event_disparity_scatter ({'camera' if kw['camera_view'] else 'projector'} view)",
        [(got.packed_map, ref.packed_map), (got.num_inliers, ref.num_inliers)]
        + list(zip(got.lanes, ref.lanes)),
    )
    errs["event_disparity_scatter"] = max(errs.get("event_disparity_scatter", 0.0), err)
    log(f"  event_disparity_scatter {kw['out_shape']} n={batch.capacity} "
        f"inliers={int(got.num_inliers)}: exact")
    for opts in (dict(emit_aux=True, packed_bgr=False),
                 dict(emit_aux=False, packed_bgr=False),
                 dict(emit_aux=False, packed_bgr=True)):
        a = tail(ref.packed_map, tables, plan, **opts)
        b = tail_plain(ref.packed_map, tables, plan, **opts)
        err = assert_exact(f"{tail_name} {opts}", list(zip(a, b)))
        errs[tail_name] = max(errs.get(tail_name, 0.0), err)
        log(f"  {tail_name} {opts} -> {tuple(a[0].shape)}: exact")
    return batch, t_bin, kw, ref.packed_map


def filter_batch(eng, batch, name):
    """The dedup filter ``name`` on ``batch``, as ``depth_frame`` runs it."""
    from xmaps_tpu_torch.ops.frame_pipeline import filter_events

    return filter_events(batch, eng.tables, eng.cfg.replace(frame_filter=name))


def filter_parity(eng, ev, errs):
    """Kernel 1 with each dedup filter's scatter priority (and the
    filtered batch) against its plain version on the card."""
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter,
        event_disparity_scatter_plain,
    )
    from xmaps_tpu_torch.ops.disparity import scale_time
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES

    kw = view_kwargs(eng)[0]
    batch = eng.make_batch(ev)
    inliers = []
    for name in FILTER_NAMES[1:]:
        fb = filter_batch(eng, batch, name)
        t_bin = scale_time(fb.batch.t, fb.batch.valid, eng.cfg.t_px_scale)
        args = (fb.batch, t_bin, eng.tables)
        got = event_disparity_scatter(*args, want_lanes=True, priority=fb.scatter_priority, **kw)
        ref = event_disparity_scatter_plain(*args, want_lanes=True,
                                            priority=fb.scatter_priority, **kw)
        err = assert_exact(
            f"event_disparity_scatter {name} ({'camera' if kw['camera_view'] else 'projector'})",
            [(got.packed_map, ref.packed_map), (got.num_inliers, ref.num_inliers)]
            + list(zip(got.lanes, ref.lanes)))
        errs["event_disparity_scatter"] = max(errs["event_disparity_scatter"], err)
        inliers.append(int(got.num_inliers))
    log(f"  event_disparity_scatter with each dedup filter's priority {kw['out_shape']}: "
        f"exact; inliers {dict(zip(FILTER_NAMES[1:], inliers))}")


def phase_filters(card, errs, engines, frames, eng_e, esl_frames):
    """Phase 5b: the dedup filters.  Kernel 1 with each filter's priority
    against its plain version, then each of the four dedup filters through
    ``set_frame_filter`` + ``process_frame`` on the demonstrator frames in
    both views, and first_per_yt on the ESL frames, every frame bit-equal
    to the CPU port.  Returns the launches of those frames, counted from 0
    just before them and read just after (the CPU comparisons launch
    nothing)."""
    import torch
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES

    log("phase 5b dedup frame filters:")
    for eng in engines.values():
        filter_parity(eng, frames[0], errs)
    runs = [(name, view, eng, frames) for name in FILTER_NAMES[1:]
            for view, eng in engines.items()]
    runs.append(("first_per_yt", "esl_projector", eng_e, esl_frames))
    unfiltered = {view: [int(eng.process_frame(ev).num_inliers) for ev in frames]
                  for view, eng in engines.items()}
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for name, view, eng, fr in runs:
        eng.set_frame_filter(name)
        outs = [eng.process_frame(ev) for ev in fr]
        cpu = eng.to("cpu")
        for i, (ev, got) in enumerate(zip(fr, outs)):
            assert_exact(f"{name} {view} frame {i} cuda vs cpu",
                         frame_pairs(got, cpu.process_frame(ev)))
        inl = [int(o.num_inliers) for o in outs]
        if view in unfiltered and not (all(0 < a <= b for a, b in zip(inl, unfiltered[view]))
                                       and sum(inl) < sum(unfiltered[view])):
            raise AssertionError(f"{name} {view}: inliers {inl} vs unfiltered {unfiltered[view]}")
        log(f"  {name} {view}: {len(fr)} frames bit-equal to the CPU port; inliers "
            f"{min(inl)}..{max(inl)}" + (f" (unfiltered {min(unfiltered[view])}.."
                                         f"{max(unfiltered[view])})" if view in unfiltered else ""))
        eng.set_frame_filter("none")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    n, n_e = len(FILTER_NAMES[1:]) * len(frames), len(esl_frames)
    want = {k: 0 for k in launches}
    want.update(event_disparity_scatter=2 * n + n_e, tail_projector=n + n_e, colorize_camera=n)
    if launches != want:
        raise AssertionError(f"filter launches {launches} != {want}")
    log(f"  launches {launches} {card}")
    return launches


def time_filters(card, eng, frames):
    """Phase 6, the filters: per dedup filter, wall ms a frame (median of
    60), device ms a frame (profiler, 48 frames) and the device time of the
    filter's own ops (``filter_events``: the rectify gather for
    first_per_yt, then ``apply_frame_filter``) on frame 0."""
    import torch
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES

    view = "camera" if eng.cfg.camera_perspective else "projector"
    batch = eng.make_batch(frames[0])
    for name in FILTER_NAMES[1:]:
        eng.set_frame_filter(name)
        w, p90, dev, _ = time_frames(eng, frames)
        ops, by_name = profile_calls(lambda: filter_batch(eng, batch, name), 48)
        if ops is None:
            raise AssertionError("torch.profiler recorded no device event for a filter")
        top = ", ".join(f"{k[:40]} {v * 1e3:.2f}" for k, v in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:3])
        log(f"  {view} {name}: {w:.4f} ms/frame wall median (p90 {p90:.4f}), {dev:.4f} "
            f"ms/frame device; filter ops {ops * 1e3:.2f} us device (top us: {top}) {card}")
        eng.set_frame_filter("none")
    torch.cuda.synchronize()


def time_frames(eng, frames):
    """(wall ms median, wall p90, device ms a frame, device ms by event
    name) of display-only packed ``process_frame`` calls: wall over 60 warm
    frames (host clock + synchronize), device over 48 more (profiler)."""
    import torch

    for ev in frames:
        eng.process_frame(ev, display_only=True, display_packed=True)
    torch.cuda.synchronize()
    wall = []
    for i in range(60):
        ev = frames[i % len(frames)]
        t0 = time.perf_counter()
        eng.process_frame(ev, display_only=True, display_packed=True)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    it = itertools.cycle(frames)
    dev, by_name = profile_calls(
        lambda: eng.process_frame(next(it), display_only=True, display_packed=True), 48)
    if dev is None:
        raise AssertionError("torch.profiler recorded no device event for a frame")
    return statistics.median(wall), statistics.quantiles(wall, n=10)[-1], dev, by_name


def time_events(fn, iters):
    """Mean ms per call over ``iters`` back-to-back calls, between two CUDA
    events.  Where the host issues the calls more slowly than the card runs
    them, this is the host's issue rate, not the device time."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_calls(fn, iters):
    """Device ms per call of ``fn`` over ``iters`` calls under
    torch.profiler: the summed duration of every device-side event the
    calls launched (kernels, memsets, copies), in total and by event name.
    Returns (None, {}) if the profiler recorded no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # an empty session first: device records of work run outside a session
    # that are still buffered are delivered to it, not counted below
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3 / iters
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
    if not by_name:
        return None, {}
    return sum(by_name.values()), by_name


def device_ms(fn, iters=50):
    """(device ms per call, how it was measured, CUDA-event ms per call,
    device ms per call by event name): the profiler's device time, or the
    CUDA-event time where the profiler recorded nothing."""
    dev, by_name = profile_calls(fn, iters)
    ev = time_events(fn, iters)
    return (dev, "profiler", ev, by_name) if dev is not None else (ev, "cuda_events", ev, {})


def time_pair(kernel_fn, plain_fn):
    """Kernel vs plain in turns (plain, kernel, kernel, plain) after a
    warm-up of each; each entry is a mean of the two turns."""
    kernel_fn()
    plain_fn()
    p1 = device_ms(plain_fn)
    k1 = device_ms(kernel_fn)
    k2 = device_ms(kernel_fn)
    p2 = device_ms(plain_fn)

    def mean(a, b):
        top = sorted(b[3].items(), key=lambda kv: -kv[1])[:3]
        return dict(ms=(a[0] + b[0]) / 2, source=a[1], issue_ms=(a[2] + b[2]) / 2,
                    turns=(a[0], b[0]), top=[(k[:40], round(v, 6)) for k, v in top])

    return mean(k1, k2), mean(p1, p2)


def write_cv_yaml(path, matrices) -> None:
    """An OpenCV FileStorage yaml of ``(name, matrix)`` pairs, each value
    written as repr(float) so it reads back exactly."""
    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        for name, m in matrices:
            m = np.atleast_2d(np.asarray(m, dtype=np.float64))
            data = ", ".join(repr(float(v)) for v in m.ravel())
            f.write(f"{name}: !!opencv-matrix\n   rows: {m.shape[0]}\n"
                    f"   cols: {m.shape[1]}\n   dt: d\n   data: [ {data} ]\n")


def write_esl_yaml(path, calib) -> None:
    """An ESL calibration yaml (OpenCV FileStorage dialect) of ``calib``."""
    write_cv_yaml(path, (("cam_K", calib.camera_K), ("cam_kc", calib.camera_D),
                         ("proj_K", calib.projector_K), ("proj_kc", calib.projector_D),
                         ("R", calib.cam2proj_R), ("T", calib.cam2proj_T)))


def write_xmaps_yaml(path, calib) -> None:
    """An X-maps calibration yaml (the replay app's ``--calib`` dialect,
    ``CalibrationParams.from_yaml``) of ``calib``; projector distortion is
    not part of the dialect."""
    write_cv_yaml(path, (("camera_intrinsic_matrix", calib.camera_K),
                         ("camera_distortion_coefficients", calib.camera_D),
                         ("projector_intrinsic_matrix", calib.projector_K),
                         ("relative_rotation", calib.cam2proj_R),
                         ("relative_translation", calib.cam2proj_T)))


def run_app(main_fn, argv, launch_expect):
    """One eval app through its main, with its stdout kept out of the log;
    the launch counts are reset just before and checked just after.
    Returns (launch counts, the app's stdout)."""
    import contextlib
    import io

    import torch
    from xmaps_tpu_torch.ops import _build

    out = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__}.main returned {rc}:\n{out.getvalue()}")
    want = {k: launch_expect.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{main_fn.__module__} launches {launches} != {want}")
    return launches, out.getvalue()


def wall_ms(fn, iters):
    """Median host-clock ms of ``fn`` + synchronize over ``iters`` calls,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def median_depth_close(what, depth, z, tol):
    d = depth[depth > 0]
    med = float(np.median(d)) if d.size else float("nan")
    if not (np.isfinite(depth).all() and d.size > 1000 and abs(med - z) < tol * z):
        raise AssertionError(f"{what}: median depth {med} ({d.size} px) vs plane {z}")
    return med


def phase7_offline_eval(card, errs, kernels_ms, shapes, library_ms):
    """Phase 7: the offline evaluation chain at the ESL geometry."""
    import tempfile
    from pathlib import Path

    import torch
    from xmaps_tpu_torch.apps import eval_esl, eval_mc3d, eval_table, eval_xmaps
    from xmaps_tpu_torch.calib.maps import CalibrationParams, CamProjMaps
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.ops.esl_search import esl_search_box, esl_search_box_plain, rows_monotone
    from xmaps_tpu_torch.ops.event_batch import EventBatch
    from xmaps_tpu_torch.ops.remap import remap_gather, remap_gather_plain
    from xmaps_tpu_torch.utils.denoise import (
        bilateral_filter,
        median_blur_3x3,
        tv_denoise_split_bregman,
    )
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration, simulate_plane_events

    dev = torch.device("cuda")
    n_scans = len(ESL_DISPARITIES)
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    seqs = {"cuda": root / "cuda" / "seq1", "cpu": root / "cpu" / "seq1"}
    for seq in seqs.values():
        (seq / "scans_np").mkdir(parents=True)
    syn = make_synthetic_calibration(*ESL_CAM, *ESL_PROJ)
    yaml_path = str(root / "calib.yaml")
    write_esl_yaml(yaml_path, syn)
    calib = CalibrationParams.from_esl_yaml(yaml_path, *ESL_CAM, *ESL_PROJ,
                                            rectification_scale=3.0)
    cache = os.path.expanduser("~/.cache/xmaps_tpu_torch")
    t0 = time.perf_counter()
    maps = CamProjMaps.build_cached(calib, zero_undistort_proj_map=True, cache_dir=cache)
    maps_s = time.perf_counter() - t0
    p03 = float(maps.P2[0, 3])
    proj_rect = maps.build_rectified_time_map(scan_upwards=False, border_replicate=False)
    if not rows_monotone(proj_rect):
        raise AssertionError("rectified projector ramp: rows not monotone")
    depths = [p03 / d for d in ESL_DISPARITIES]
    cams_raw = []
    for i, z in enumerate(depths):
        ev = simulate_plane_events(syn, depth_m=z, scan_upwards=False)
        img = np.zeros(ESL_CAM[::-1], np.float64)
        img[ev["y"], ev["x"]] = (ev["t"] + 1) / (ev["t"].max() + 1)
        np.save(seqs["cuda"] / "scans_np" / f"scan{i:03d}.npy", img)
        if i == 0:
            np.save(seqs["cpu"] / "scans_np" / f"scan{i:03d}.npy", img)
        cams_raw.append(img)
    log(f"phase 7 offline eval (ESL geometry): camera {ESL_CAM[0]}x{ESL_CAM[1]}, projector "
        f"{ESL_PROJ[0]}x{ESL_PROJ[1]}, rect {calib.rect_image_height}x"
        f"{calib.rect_image_width}; maps {maps_s:.1f} s; p03 {p03:.3f}; "
        f"{n_scans} plane scans at z = {[round(z, 4) for z in depths]} m "
        f"(disparities {ESL_DISPARITIES}), {[int((c > 0).sum()) for c in cams_raw]} px lit "
        f"{card}")

    # -- the fast depth init, its tables, kernels A and B against plain
    t0 = time.perf_counter()
    fast = eval_esl.build_device_depth_init(maps, calib, proj_rect, p03, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bound = fast.bound
    prep_mb = sum(t.numel() * t.element_size() for t in bound["prep"]) / 1e6
    remap_mb = sum(t.numel() * t.element_size()
                   for t in bound["forward"] + bound["back"]) / 1e6
    box = tuple(bound["prep"][0].shape)
    log(f"  depth-init setup {setup_s:.2f} s: box {box[0]}x{bound['forward'][0].shape[1]} "
        f"(tables {box[0]}x{box[1]}), prep tables {prep_mb:.1f} MB, remap indices "
        f"{remap_mb:.1f} MB on the card {card}")
    cams = [eval_esl.normalize_scan(c) for c in cams_raw]
    cam_dev = [torch.from_numpy(c).to(dev) for c in cams]
    fwd, back, prep, search = bound["forward"], bound["back"], bound["prep"], bound["search"]
    cam_box = remap_gather(cam_dev[0], *fwd)
    e_fwd = assert_exact("remap_gather forward (camera -> box)",
                         [(cam_box, remap_gather_plain(cam_dev[0], *fwd))])
    disp_box = esl_search_box(cam_box, prep, **search)
    e_a = assert_exact("esl_disparity_search (box)",
                       [(disp_box, esl_search_box_plain(cam_box, prep, **search))])
    disp_cam = remap_gather(disp_box, *back)
    e_back = assert_exact("remap_gather back (box -> camera)",
                          [(disp_cam, remap_gather_plain(disp_box, *back))])
    errs["esl_disparity_search"] = e_a
    errs["remap_gather"] = max(e_fwd, e_back)
    log(f"  kernels A and B vs plain on the card: exact (box {tuple(disp_box.shape)}, "
        f"{int((disp_box != 0).sum())} disparities; camera view {int((disp_cam != 0).sum())})")
    for i in range(2):
        got = fast(cam_dev[i])
        want = eval_esl.depth_init_dense(cams[i], maps, proj_rect, p03, dev)
        assert_exact(f"ESL depth init scan {i}: kernels vs brute force",
                     [(got[0].cpu(), torch.from_numpy(want[0])),
                      (got[1].cpu(), torch.from_numpy(want[1]))])
    log("  ESL depth init (kernels A+B) == brute force (dense search on the card, host "
        "remaps) on scans 0 and 1: exact")

    # -- the four apps through main, on the card and (scan 0) on the CPU
    common = ["-calib", yaml_path, "-num_scans", str(n_scans),
              "-cam_width", str(ESL_CAM[0]), "-cam_height", str(ESL_CAM[1]),
              "-proj_width", str(ESL_PROJ[0]), "-proj_height", str(ESL_PROJ[1])]
    args = {k: ["-object_dir", str(seq)] + common for k, seq in seqs.items()}
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    launches = {}
    n = n_scans
    la, _ = run_app(eval_esl.main, args["cuda"] + ["-device", "cuda"],
                    {"esl_disparity_search": n, "remap_gather": 2 * n})
    esl_peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 1e6
    lm, _ = run_app(eval_mc3d.main, args["cuda"] + ["-device", "cuda"], {})
    lx, _ = run_app(eval_xmaps.main, args["cuda"] + ["-device", "cuda"],
                    {"event_disparity_scatter": n, "colorize_camera": n})
    for part in (la, lx):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    _, table = run_app(eval_table.main,
                       ["-object_dir", str(seqs["cuda"].parent), "-scenes", "seq1",
                        "-min_depth", "0.2", "-max_depth", "2"], {})
    for row in ("ESL (init)", "MC3D", "X-Maps (ours)"):
        if row not in table:
            raise AssertionError(f"eval_table: no {row!r} row in\n{table}")
    log(f"  apps on the card: eval_esl launches {la['esl_disparity_search']} A + "
        f"{la['remap_gather']} B for {n} scans (peak {esl_peak_mb:.1f} MB above the "
        f"resident tables), eval_mc3d no kernel, eval_xmaps "
        f"{lx['event_disparity_scatter']} x kernel 1 + {lx['colorize_camera']} x kernel 3 "
        f"at capacity {ESL_CAM[0] * ESL_CAM[1]}")
    log("  eval_table:\n" + "\n".join("    " + line for line in table.strip().splitlines()))

    def load(seq, sub, i=0):
        return np.load(seq / sub / f"scans{i:03d}.npy")

    for i, z in enumerate(depths):
        meds = [median_depth_close(f"{sub} scan {i}", load(seqs["cuda"], sub, i), z, tol)
                for sub, tol in (("esl/depth_init", 0.05), ("mc3d/depth", 0.10),
                                 ("x_maps/depth_init", 0.05))]
        log(f"  scan {i}: plane {z:.4f} m; median depth ESL init {meds[0]:.4f}, "
            f"MC3D {meds[1]:.4f}, X-maps {meds[2]:.4f}")

    # scan 0 on the CPU port (X-maps through the same engine moved to the CPU)
    cpu_args = args["cpu"] + ["-num_scans", "1", "-device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        if eval_esl.main(cpu_args) != 0 or eval_mc3d.main(cpu_args) != 0:
            raise AssertionError("eval on the CPU failed")
    for sub in ("esl/disparity_init", "esl/depth_init", "mc3d/depth"):
        assert_exact(f"{sub} scan 0 cuda vs cpu",
                     [(torch.from_numpy(load(seqs["cuda"], sub)),
                       torch.from_numpy(load(seqs["cpu"], sub)))])
    a, b = load(seqs["cuda"], "esl/depth_optim"), load(seqs["cpu"], "esl/depth_optim")
    init = load(seqs["cuda"], "esl/depth_init").astype(np.float64)
    differ = a != b
    if (not np.array_equal(a > 0, b > 0) or differ.mean() > 0.02
            or (np.abs(a.astype(np.float64) - b) > 2 * init ** 2 / p03 + 1e-6).any()):
        raise AssertionError(f"esl/depth_optim cuda vs cpu: {int(differ.sum())} px differ")
    fa = load(seqs["cuda"], "esl/depth_optim_filtered")
    fb = load(seqs["cpu"], "esl/depth_optim_filtered")
    f_err = float(np.abs(fa.astype(np.float64) - fb).max())
    if f_err > 1e-3:
        raise AssertionError(f"esl/depth_optim_filtered cuda vs cpu: max |diff| {f_err}")
    eng = XMapsDepthEngine.from_calibration(
        CalibrationParams.from_esl_yaml(yaml_path, *ESL_CAM, *ESL_PROJ), device="cuda",
        event_capacity=ESL_CAM[0] * ESL_CAM[1], camera_perspective=True, scan_upwards=False,
        border_replicate=False, zero_undistort_proj_map=True, xmap_cache_dir=cache,
    )
    events = eval_xmaps.scan_image_to_events(cams_raw[0])
    batch_args = (events["x"], events["y"], events["t"], events["p"], eng.cfg.event_capacity)
    batch = EventBatch.from_arrays(*batch_args, device="cuda")
    got = eng.process_batch_device(batch)
    ref = eng.to("cpu").process_batch_device(EventBatch.from_arrays(*batch_args, device="cpu"))
    assert_exact("X-maps scan 0 cuda vs cpu", frame_pairs(got, ref) + [
        (torch.from_numpy(load(seqs["cuda"], "x_maps/depth_init")), ref.depth)])
    log(f"  scan 0 vs the CPU port: ESL init, MC3D, X-maps ({len(events['x'])} events) "
        f"exact; refined {int(differ.sum())} of {differ.size} px differ; filtered max "
        f"|diff| {f_err:.3g} m")

    # -- per-scan times, device (profiler) and wall
    plan = eval_esl.RefinePlan(calib, maps, 3, *ESL_PROJ)
    disp0, depth0 = fast(cam_dev[0])
    cam_ref = cams[0].copy()
    cam_ref[cam_ref == 0] = 1.0 / cam_ref[0, 0] if cam_ref[0, 0] != 0 else np.inf
    cam_ref = torch.from_numpy(cam_ref).to(dev)
    optim = eval_esl.depth_optimization_dense(depth0, cam_ref, plan)
    raw0 = torch.from_numpy(cams_raw[0].astype(np.float32)).to(dev)
    tables = eval_mc3d.build_mc3d_tables(calib, *ESL_PROJ, *ESL_CAM)
    stages = (
        ("ESL depth init (kernels A+B)", lambda: fast(cam_dev[0]), 20),
        ("ESL depth init brute force", lambda: eval_esl.depth_init_dense(
            cams[0], maps, proj_rect, p03, dev), 1),
        ("ESL refinement", lambda: eval_esl.depth_optimization_dense(depth0, cam_ref, plan), 3),
        ("ESL denoise (bilateral + TV)", lambda: tv_denoise_split_bregman(
            bilateral_filter(optim, d=5, sigma_color=3.0, sigma_space=3.0), mu=0.5), 3),
        ("MC3D (median + search)", lambda: eval_mc3d.mc3d_disparity_dense(
            median_blur_3x3(raw0), tables, *ESL_PROJ), 3),
        ("X-maps (kernels 1+3)", lambda: eng.process_batch_device(batch), 20),
    )
    log(f"  per-scan times {card}:")
    for name, fn, iters in stages:
        w = wall_ms(fn, iters)
        d, by_name = profile_calls(fn, iters)
        if d is None:
            raise AssertionError(f"torch.profiler recorded no device event for {name}")
        top = ", ".join(f"{k[:40]} {v:.4f}" for k, v in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:3])
        log(f"    {name}: {w:.4f} ms/scan wall (median of {iters}), {d:.4f} ms/scan device; "
            f"top: {top}")
    kernels_ms["esl_disparity_search"] = time_pair(
        lambda: esl_search_box(cam_box, prep, **search),
        lambda: esl_search_box_plain(cam_box, prep, **search),
    )
    kernels_ms["remap_gather"] = time_pair(
        lambda: (remap_gather(cam_dev[0], *fwd), remap_gather(disp_box, *back)),
        lambda: (remap_gather_plain(cam_dev[0], *fwd), remap_gather_plain(disp_box, *back)),
    )
    shapes["esl_disparity_search"] = (cam_box.numel(),)
    shapes["remap_gather"] = [
        (yi.numel(), int((xi < src.shape[1]).sum() if inb is None else inb.sum()),
         src.numel(), int(inb is not None))
        for src, (yi, xi, inb) in ((cam_dev[0], fwd), (disp_box, back))]
    library_ms["remap_gather"] = remap_library_ms(cam_dev[0], fwd, disp_box, back)
    for k in ("esl_disparity_search", "remap_gather"):
        km, pm = kernels_ms[k]
        log(f"  kernel {k}: {km['ms']:.5f} ms device ({km['source']}), plain {pm['ms']:.5f} ms"
            f" per scan (ESL box; remap = forward + back) {card}")
    tmp.cleanup()
    log(f"  phase 7 total {time.perf_counter() - t_phase:.1f} s {card}")
    return launches


@contextlib.contextmanager
def record_pipe():
    """Record what every DepthReprojectionPipe does while the block runs:
    the host clock at each trigger (the trigger finder's frame callback),
    each dispatched frame's segmented events and device result, the host
    clock when its result reached the host (frame fetched or inlier count
    read), the pipe's engine and its stats."""
    from xmaps_tpu_torch.io.prefetch import HostStagingPool as Pool
    from xmaps_tpu_torch.runtime.pipe import DepthReprojectionPipe as Pipe

    rec = dict(t_trigger=[], events=[], results=[], t_ready=[], engine=None, stats=None,
               staged=[])
    orig = {k: getattr(Pipe, k) for k in
            ("process_ev_frame", "_dispatch_segmented", "_flush_pending")}
    orig_pool = {k: getattr(Pool, k) for k in ("stage", "stage_compact")}

    def staging(name):
        def stage(self, evs):
            rec["staged"].append(name)
            return orig_pool[name](self, evs)
        return stage

    def process_ev_frame(self, evs):
        rec["t_trigger"].append(time.perf_counter())
        orig["process_ev_frame"](self, evs)

    def dispatch(self, evs):
        rec["events"].append(evs.copy())
        rec["engine"], rec["stats"] = self.engine, self.stats_printer
        orig["_dispatch_segmented"](self, evs)
        rec["results"].append(self._pending)

    def flush(self):
        pending = self._pending is not None
        orig["_flush_pending"](self)
        if pending:
            rec["t_ready"].append(time.perf_counter())

    Pipe.process_ev_frame, Pipe._dispatch_segmented, Pipe._flush_pending = (
        process_ev_frame, dispatch, flush)
    Pool.stage, Pool.stage_compact = staging("stage"), staging("stage_compact")
    try:
        yield rec
    finally:
        for k, fn in orig.items():
            setattr(Pipe, k, fn)
        for k, fn in orig_pool.items():
            setattr(Pool, k, fn)


def segment_host(raw_path, fps, width, height):
    """The frames the trigger finder emits on the recording, replayed on
    the host alone (decoder, activity filter, trigger finder; no engine)."""
    from xmaps_tpu_torch.io.event_iterator import FileEventsIterator
    from xmaps_tpu_torch.io.filters import ActivityNoiseFilter
    from xmaps_tpu_torch.runtime.trigger_finder import RobustTriggerFinder
    from xmaps_tpu_torch.utils.stats import StatsPrinter

    frames = []
    act = ActivityNoiseFilter(width, height, window_us=int(1e6 / fps), keep_polarity=1)
    finder = RobustTriggerFinder(projector_fps=fps, stats=StatsPrinter(silent=True),
                                 frame_callback=lambda evs: frames.append(evs.copy()))
    for packet in FileEventsIterator(raw_path, delta_t=1e6 / fps / 4):
        if len(packet):
            finder.process_events(act.process(packet))
    return frames


def replay(app, argv, want_tail, expect_frames, keys=""):
    """One run of the replay app's ``main`` on the card, its stdout kept
    out of the log, with the launch counts reset just before and read just
    after; ``keys`` are pressed on the processor (its keyboard callback)
    before the replay starts.  Checks that the pipe dispatched exactly
    ``expect_frames`` (the trigger finder's frames, from segment_host), the
    counts and the launches; returns (record, counters, replay-loop wall
    seconds)."""
    import torch
    from xmaps_tpu_torch.ops import _build

    loop_s = []
    orig_loop = app.project_events

    def timed_loop(*a, **kw):
        for key in keys:
            a[-1].keyboard_cb(ord(key))
        t0 = time.perf_counter()
        orig_loop(*a, **kw)
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t0)

    out = io.StringIO()
    torch.cuda.synchronize()
    app.project_events = timed_loop
    _build.reset_launch_counts()
    try:
        with record_pipe() as rec, contextlib.redirect_stdout(out):
            app.main.main(args=argv, standalone_mode=False)
    finally:
        app.project_events = orig_loop
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    counters = dict(rec["stats"]._global.counters)
    n = len(rec["events"])
    trig = counters.get("trig ok", 0)
    shown = counters.get("frames shown", 0)
    skipped = counters.get("frames computed (display skipped)", 0)
    if not (n == len(expect_frames) == trig == counters.get("frames dispatched")
            == shown + skipped == len(rec["t_ready"])):
        raise AssertionError(f"replay counts: {n} dispatched, {len(expect_frames)} "
                             f"segmented, {counters}\n{out.getvalue()}")
    for i, (got, want) in enumerate(zip(rec["events"], expect_frames)):
        if not np.array_equal(got, want):
            raise AssertionError(f"replay frame {i}: events differ from the trigger finder's")
    want = {k: 0 for k in launches}
    want.update({"event_disparity_scatter": n, want_tail: n})
    if launches != want:
        raise AssertionError(f"replay launches {launches} != {want}")
    return rec, counters, loop_s[0]


def check_replay_frames(what, rec, errs):
    """Every frame the pipe computed on the card equals the CPU port's
    process_staged of the same segmented events, staged as the pipe stages
    them (1 word an event; 2 words with a dedup filter), bit for bit."""
    from xmaps_tpu_torch.io.prefetch import HostStagingPool

    cpu = rec["engine"].to("cpu")
    pool = HostStagingPool(cpu.cfg.event_capacity, device="cpu", layout=cpu.compact_layout)
    how = "stage" if cpu.cfg.frame_filter != "none" else "stage_compact"
    if rec["staged"] != [how] * len(rec["events"]):
        raise AssertionError(f"{what}: the pipe staged {set(rec['staged'])}, not {how}")
    lit = []
    for i, (ev, got) in enumerate(zip(rec["events"], rec["results"])):
        ref = cpu.process_staged(getattr(pool, how)(ev))
        errs["event_disparity_scatter"] = max(errs["event_disparity_scatter"], assert_exact(
            f"{what} frame {i} card vs CPU port",
            [(got.frame_bgr, ref.frame_bgr), (got.num_inliers, ref.num_inliers)]))
        lit.append(float((ref.frame_bgr != 0xFFFFFF).float().mean()))
    if min(lit) < 0.05:
        raise AssertionError(f"{what}: a frame with {min(lit):.3f} of its pixels defined")
    return lit


def trace_device_ms(path):
    """(device ms of all kernels, copies and memsets; ms of the
    host-to-device copies) in a torch.profiler chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = h2d = 0.0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev += e["dur"] / 1e3
            if e["cat"] == "gpu_memcpy" and "HtoD" in e.get("name", ""):
                h2d += e["dur"] / 1e3
    return dev, h2d


def phase8_streaming(card, errs):
    """Phase 8: the streaming replay app at the demonstrator rig."""
    import tempfile
    from pathlib import Path

    import torch
    from xmaps_tpu_torch.apps import depth_reprojection as app
    from xmaps_tpu_torch.io.evt_encode import encode_evt3
    from xmaps_tpu_torch.io.prefetch import HostStagingPool
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration, simulate_sequence

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    calib = make_synthetic_calibration(640, 480, 720, 1280)
    yaml_path, raw_path = str(root / "calib.yaml"), str(root / "seq.raw")
    write_xmaps_yaml(yaml_path, calib)
    depths = [0.45 + 0.005 * i for i in range(STREAM_FRAMES)]
    events = simulate_sequence(calib, depths, fps=60, subsample=0.031,
                               rng=np.random.default_rng(7))
    with open(raw_path, "wb") as f:
        f.write(encode_evt3(events, 640, 480))
    log(f"phase 8 streaming replay: {STREAM_FRAMES} frames at 60 Hz, {len(events)} events "
        f"({len(events) / STREAM_FRAMES:.0f}/frame), EVT3 {os.path.getsize(raw_path)} bytes "
        f"(made in {time.perf_counter() - t_phase:.1f} s)")
    expect = segment_host(raw_path, 60, 640, 480)
    if len(expect) < STREAM_FRAMES // 2:
        raise AssertionError(f"the trigger finder found {len(expect)} frames")
    log(f"  the trigger finder (host replay alone) emits {len(expect)} frames of "
        f"{[len(f) for f in expect[:3]]}... events")
    base = ["--calib", yaml_path, "--input", raw_path, "--z-near", str(Z_NEAR),
            "--z-far", str(Z_FAR), "--no-frame-dropping", "--window", "files",
            "--out-dir", str(root / "frames"), "--device", "cuda"]
    launches: dict = {}
    runs = {}
    for name, extra, tail, keys in (
        ("projector", [], "tail_projector", ""),
        ("camera", ["--camera-perspective"], "colorize_camera", ""),
        ("projector --low-latency", ["--low-latency"], "tail_projector", ""),
        ("projector --profile-dir", ["--profile-dir", str(root / "trace")], "tail_projector", ""),
        # one E key press: the first dedup filter, first_per_yt
        ("projector, E key (first_per_yt)", [], "tail_projector", "e"),
    ):
        rec, counters, loop_s = replay(app, base + extra, tail, expect, keys)
        for k, v in dict(event_disparity_scatter=len(rec["events"]), **{tail: len(rec["events"])}).items():
            launches[k] = launches.get(k, 0) + v
        runs[name] = (rec, counters, loop_s)
        n = len(rec["events"])
        lat = [(r - t) * 1e3 for t, r in zip(rec["t_trigger"], rec["t_ready"])]
        log(f"  {name}: trig ok {counters['trig ok']}, trig fail {counters.get('trig fail', 0)}, "
            f"shown {counters.get('frames shown', 0)} + display skipped "
            f"{counters.get('frames computed (display skipped)', 0)}; launches = frames "
            f"dispatched = {n}; replay loop {loop_s:.3f} s: {n / loop_s:.2f} frames/s, "
            f"{counters['processed evs'] / loop_s / 1e6:.2f} Mev/s ingest; trigger -> "
            f"frame ready median {statistics.median(lat):.4f} ms, p90 "
            f"{statistics.quantiles(lat, n=10)[-1]:.4f} ms {card}")

    # every frame of both views and of the filtered replay against the CPU
    # port; 2-word vs 1-word
    for name in ("projector", "camera", "projector, E key (first_per_yt)"):
        rec = runs[name][0]
        lit = check_replay_frames(name, rec, errs)
        log(f"  {name}: all {len(lit)} frames bit-equal to the CPU port's process_staged "
            f"(packed BGR + inliers; {rec['staged'][0]}, filter {rec['engine'].cfg.frame_filter})"
            f"; defined pixels {min(lit):.3f}..{max(lit):.3f}")
    rec = runs["projector"][0]
    eng = rec["engine"]
    pool = HostStagingPool(eng.cfg.event_capacity, device="cuda")
    for i, (ev, got) in enumerate(zip(rec["events"], rec["results"])):
        assert_exact(f"projector frame {i}: 2-word vs 1-word staging on the card",
                     [(eng.process_staged(pool.stage(ev)).frame_bgr, got.frame_bgr)])
    torch.cuda.synchronize()
    log(f"  2-word staging (stage) == 1-word staging (stage_compact) on the card: "
        f"{len(rec['events'])} frames exact")

    # device time, pinned H2D and busy share from the --profile-dir trace
    rec, counters, loop_s = runs["projector --profile-dir"]
    n = len(rec["events"])
    dev_ms, h2d_ms = trace_device_ms(root / "trace" / "trace.json")
    wall_ms = runs["projector"][2] * 1e3 / len(runs["projector"][0]["events"])
    log(f"  device per frame (profiled replay): {dev_ms / n:.4f} ms, of it H2D "
        f"{h2d_ms / n * 1e3:.2f} us (one pinned copy of the 1-word batch; phase 6 lists "
        f"process_frame's pageable copies); busy share "
        f"{dev_ms / (loop_s * 1e3):.4f} of the profiled replay loop, {dev_ms / n / wall_ms:.4f}"
        f" of the unprofiled one ({wall_ms:.4f} ms/frame) {card}")

    # live capture: the app without --input, on the paced synthetic camera:
    # with the PNG sink (every 30th frame fetched and encoded, the others
    # synchronised on their inlier count), and headless, where every frame
    # is fetched to the host as a display would take it
    live = ["--calib", yaml_path, "--capture", "synthetic", "--z-near", str(Z_NEAR),
            "--z-far", str(Z_FAR), "--device", "cuda"]
    files = ["--window", "files", "--out-dir", str(root / "live")]
    for name, extra in (("live --window files", files),
                        ("live --window files --low-latency", files + ["--low-latency"]),
                        ("live --window none", ["--window", "none"])):
        rec, counters, wall_s = live_run(app, live + extra)
        n = len(rec["events"])
        for k in ("event_disparity_scatter", "tail_projector"):
            launches[k] += n
        lit = check_replay_frames(name, rec, errs)
        lat = [(r - t) * 1e3 for t, r in zip(rec["t_trigger"], rec["t_ready"])]
        log(f"  {name} (synthetic camera, paced at 60 Hz, {wall_s:.3f} s): trig ok "
            f"{counters['trig ok']}, trig fail {counters.get('trig fail', 0)}, frames dropped "
            f"{counters.get('frames dropped', 0)}, frames computed "
            f"{n} ({n / wall_s:.2f}/s; floor {rec['frame_floor']}), all bit-equal to the CPU "
            f"port (defined pixels "
            f"{min(lit):.3f}..{max(lit):.3f}); trigger -> frame ready median "
            f"{statistics.median(lat):.4f} ms, p90 {statistics.quantiles(lat, n=10)[-1]:.4f} ms"
            f" {card}")
        # the host side: the watchdog's stream lag a packet (a frame is
        # dropped while it exceeds one projector period) and the stage timers
        lag = rec["lag_ms"]
        timers = rec["stats"]._global.times_ns
        log(f"    stream lag a packet ({len(lag)}): median {statistics.median(lag):.3f}, p90 "
            f"{statistics.quantiles(lag, n=10)[-1]:.3f}, max {max(lag):.3f} ms; over "
            f"{1e3 / 60:.2f} ms in {sum(v > 1e3 / 60 for v in lag)} packets, first 8 "
            f"{[round(v, 2) for v in lag[:8]]}; host ms avg/max "
            + ", ".join(f"{k} {timers[k].mean / 1e6:.3f}/{timers[k].vmax / 1e6:.3f}"
                        for k in ("main loop", "act+pol filter", "find pauses", "stage batch",
                                  "dispatch frame", "fetch stats", "fetch frame")
                        if k in timers))
    tmp.cleanup()
    log(f"  phase 8 total {time.perf_counter() - t_phase:.1f} s {card}")
    return launches


def live_run(app, argv):
    """One live run of the app's ``main`` on the card (no ``--input``),
    stopped through the processor's ``should_close`` after LIVE_S seconds
    of stream, its stdout kept out of the log, with the launch counts reset
    just before and read just after.  Returns (record, counters, seconds
    from the first packet to the close)."""
    import torch
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.runtime.processor import DepthReprojectionProcessor as Proc
    from xmaps_tpu_torch.utils.stats import StatsPrinter

    t = {}
    lag_ms = []

    def should_close(self):
        t.setdefault("first", time.perf_counter())
        t["last"] = time.perf_counter()
        return t["last"] - t["first"] >= LIVE_S

    def add_time(self, name, ns):
        if name == "stream lag":  # the watchdog's, once a packet
            lag_ms.append(ns / 1e6)
        orig_add(self, name, ns)

    out = io.StringIO()
    orig, orig_add = Proc.should_close, StatsPrinter.add_time_measure_ns
    torch.cuda.synchronize()
    Proc.should_close, StatsPrinter.add_time_measure_ns = should_close, add_time
    _build.reset_launch_counts()
    try:
        with record_pipe() as rec, contextlib.redirect_stdout(out):
            try:
                app.main.main(args=argv, standalone_mode=False)
            except SystemExit as e:  # the app's exit when the window closes
                if e.code not in (0, None):
                    raise
    finally:
        Proc.should_close, StatsPrinter.add_time_measure_ns = orig, orig_add
    rec["lag_ms"] = lag_ms
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    counters = dict(rec["stats"]._global.counters)
    n = len(rec["events"])
    shown = counters.get("frames shown", 0)
    skipped = counters.get("frames computed (display skipped)", 0)
    rec["frame_floor"] = live_frame_floor(rec["stats"]._global.times_ns, n,
                                          t["last"] - t["first"])
    if not (n >= rec["frame_floor"] and n == counters.get("trig ok")
            == counters.get("frames dispatched") == shown + skipped == len(rec["t_ready"])):
        raise AssertionError(f"live run: {n} dispatched, floor {rec['frame_floor']}, "
                             f"{counters}\n{out.getvalue()}")
    want = {k: 0 for k in launches}
    want.update(event_disparity_scatter=n, tail_projector=n)
    if launches != want:
        raise AssertionError(f"live launches {launches} != {want}")
    return rec, counters, t["last"] - t["first"]


def live_frame_floor(timers, n, wall_s):
    """The fewest frames a paced live run of ``wall_s`` seconds must compute
    at this run's measured host cost, if the watchdog drops no more than its
    design does.  The watchdog drops buffered events while the host is a
    projector period P behind the stream.  A computed frame costs F ms of
    host work on top of the per-packet work p (activity filter, pause
    search); the host then catches up q - p ms a packet (q: the stream's
    packet interval), so the events of R = F / (q - p) * q / P periods are
    dropped.  Each computed frame thus takes its own period, R periods of
    drops, and at most one more lost to the frame the drops cut (and one for
    rounding R up), so at least (S - 2) / (3 + R) of the S streamed frames
    are computed (the first two lost to the trigger finder's start-up).
    F is all main-loop time not spent on per-packet work, divided by the
    frames computed (it holds staging, launches, the fetch and the display
    sink).  Where the host cannot keep up with the packets alone, the floor
    is one frame."""
    packets = timers["act+pol filter"].n
    per_packet = sum(timers[k].total for k in ("act+pol filter", "find pauses") if k in timers)
    p = per_packet / packets / 1e6
    q = wall_s * 1e3 / packets
    if n == 0 or q <= p:
        return 1
    period = 1e3 / 60
    f = (timers["main loop"].total - per_packet) / n / 1e6
    r = f / (q - p) * q / period
    return max(1, int((wall_s * 60 - 2) / (3 + r)))


def phase9_bench(card, errs, kernels_ms, shapes, library_ms):
    """Phase 9: kernel W against its plain version, then apps.bench."""
    import torch
    from xmaps_tpu_torch.apps import bench
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.ops.warmup import WARMUP_SHAPE, warmup_add_one, warmup_add_one_plain

    x = torch.from_numpy(np.random.default_rng(9).integers(
        -(2**31), 2**31 - 1, WARMUP_SHAPE, dtype=np.int32)).cuda()
    errs["warmup_add_one"] = assert_exact(
        "warmup_add_one", [(warmup_add_one(x), warmup_add_one_plain(x))])
    kernels_ms["warmup_add_one"] = time_pair(lambda: warmup_add_one(x),
                                             lambda: warmup_add_one_plain(x))
    shapes["warmup_add_one"] = (x.numel(),)
    library_ms["warmup_add_one"] = device_ms(lambda: x + 1)[0]
    km, pm = kernels_ms["warmup_add_one"]
    log(f"phase 9 kernel W warmup_add_one {WARMUP_SHAPE}: exact; {km['ms']:.5f} ms device "
        f"({km['source']}), plain {pm['ms']:.5f} ms {card}")
    out = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = bench.main([])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    frames = bench.N_FRAMES + bench.SYNC_FRAMES + bench.ROUNDS * bench.N_FRAMES
    want = {k: 0 for k in launches}
    want.update(warmup_add_one=1, event_disparity_scatter=frames, tail_projector=frames)
    if rc != 0 or launches != want:
        raise AssertionError(f"apps.bench rc {rc}, launches {launches} != {want}")
    line = out.getvalue().strip().splitlines()[-1]
    result = json.loads(line)
    if not (result["value"] > 0 and result["extra"]["gpu"]):
        raise AssertionError(f"apps.bench: {line}")
    log(f"  apps.bench launches {launches}; its JSON line:")
    print(line, flush=True)
    return launches


def phase10_store_loop(card, errs, kernels_ms, shapes, library_ms):
    """Phase 10: kernel S against its plain version (at the benchmark's
    shape and at ragged ones), then one run of apps.bench_store_loop, whose
    JSON line is printed and gives kernel S's times for the ``kernels``
    line (kernel, plain, and the library call where it computed the same
    tile).  Returns the bench's launches, counted from 0 just before it and
    read just after."""
    import torch
    from xmaps_tpu_torch.apps import bench_store_loop
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.ops.store_loop import (
        BENCH_EVENTS,
        BENCH_SHAPE,
        tile_store_last,
        tile_store_last_plain,
    )

    err = 0.0
    for n, shape in ((BENCH_EVENTS, BENCH_SHAPE), (5000, (13, 3100)), (300, (3, 5))):
        r, c, v = bench_store_loop.make_inputs(n, shape, seed=n, device="cuda")
        r[::53], c[::61] = -2, shape[1]  # events outside the tile
        err = max(err, assert_exact(f"tile_store_last {n} events into {shape}", [
            (tile_store_last(r, c, v, shape), tile_store_last_plain(r, c, v, shape))]))
    rows, cols, vals = bench_store_loop.make_inputs(BENCH_EVENTS, BENCH_SHAPE, device="cuda")
    err = max(err, assert_exact("tile_store_last at the benchmark's draws", [
        (tile_store_last(rows, cols, vals, BENCH_SHAPE),
         tile_store_last_plain(rows, cols, vals, BENCH_SHAPE))]))
    errs["tile_store_last"] = err
    log(f"phase 10 kernel S tile_store_last {BENCH_EVENTS} events into {BENCH_SHAPE} "
        f"(and ragged shapes, events outside the tile): exact")
    out = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = bench_store_loop.main([])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = {k: 0 for k in launches}
    # one check, then two turns of (1 warm-up + ITERS) calls
    want["tile_store_last"] = 1 + 2 * (1 + bench_store_loop.ITERS)
    if rc != 0 or launches != want:
        raise AssertionError(f"apps.bench_store_loop rc {rc}, launches {launches} != {want}")
    line = out.getvalue().strip().splitlines()[-1]
    result = json.loads(line)
    if not (result["device"] == "cuda" and result["gpu"]
            and result["timing"] == "profiler_device" and result["kernel_ns_per_store"] > 0):
        raise AssertionError(f"apps.bench_store_loop: {line}")
    kernels_ms["tile_store_last"] = tuple(
        dict(ms=result[f"{k}_ms"], source="profiler (apps.bench_store_loop)", issue_ms=None,
             turns=tuple(result[f"{k}_turns_ms"]), top=[])
        for k in ("kernel", "plain"))
    shapes["tile_store_last"] = (BENCH_EVENTS, *BENCH_SHAPE)
    library_ms["tile_store_last"] = result["library_ms"] if result["library_equal"] else None
    log(f"  apps.bench_store_loop launches {launches}; index_put_ (deterministic) "
        f"{'equal to' if result['library_equal'] else 'NOT equal to (a yardstick only)'} "
        f"the plain version; its JSON line {card}:")
    print(line, flush=True)
    return launches


def remap_library_ms(cam, fwd, disp_box, back):
    """Device ms of torch.take computing kernel B's forward + back remaps
    (flat indices into the source with one zero appended, for the
    out-of-bounds destinations), precomputed outside the timing."""
    import torch
    from xmaps_tpu_torch.ops.remap import remap_gather_plain

    calls = []
    for src, (yi, xi, inb) in ((cam, fwd), (disp_box, back)):
        Hs, Ws = src.shape
        flat = torch.cat([src.reshape(-1), src.new_zeros(1)])
        idx = yi.long() * Ws + xi.long().clamp(max=Ws - 1)
        ok = xi < Ws if inb is None else inb & (xi < Ws)
        calls.append((flat, torch.where(ok, idx, Hs * Ws)))
        assert_exact("torch.take as kernel B's function", [
            (torch.take(*calls[-1]), remap_gather_plain(src, yi, xi, inb))])
    return device_ms(lambda: [torch.take(f, i) for f, i in calls])[0]


def kernel_bytes(name, shapes) -> float:
    """The bytes ``name`` must move on the main path's inputs of this run:
    each input read once, each output written once; for gathers, one
    element per lane that needs it (at most the whole table)."""
    s = shapes[name]
    if name == "event_disparity_scatter":
        n, inl, lut_b, xmap_b, out_px = s
        return 13 * n + min(4 * inl, lut_b) + min(2 * inl, xmap_b) + 4 * out_px + 4
    if name == "tail_projector":
        crop_px, proj_px = s
        return 4 * crop_px + 2 * 2 * proj_px + 4 * 256 + 4 * proj_px
    if name == "colorize_camera":
        (px,) = s
        return 4 * px + 4 * 256 + 4 * px
    if name == "esl_disparity_search":
        # the box in and out; the table bytes a search touches are
        # data-dependent and shared by neighbouring pixels (unknown here),
        # so they are left out and the bound stays a lower bound
        (box_px,) = s
        return 4 * box_px + 4 * box_px
    if name == "remap_gather":
        # per call: (destination px, in-bounds px, source px, has an inb mask)
        return sum((8 + has_inb) * px + 4 * min(n_in, src_px) + 4 * px
                   for px, n_in, src_px, has_inb in s)
    if name == "warmup_add_one":
        (n,) = s
        return 8 * n
    if name == "tile_store_last":
        # rows, cols and vals in (12 B an event), the tile out
        n, h, w = s
        return 12 * n + 4 * h * w
    raise KeyError(name)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 2

    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter,
        event_disparity_scatter_plain,
    )
    from xmaps_tpu_torch.ops.cuda_tail import (
        colorize_camera,
        colorize_camera_plain,
        tail_projector,
        tail_projector_plain,
    )
    from xmaps_tpu_torch.ops.xmap import build_x_map
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))
    cache_dir = os.path.join(root, "build", "xmaps_tpu_torch", "cache")
    t_start = time.perf_counter()

    # -- 1. device -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")

    # -- 2. kernel build -------------------------------------------------
    t0 = time.perf_counter()
    _build.load(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {build_s:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")

    # -- engines at the demonstrator rig ---------------------------------
    calib = make_synthetic_calibration(640, 480, 720, 1280)
    kw = dict(event_capacity=CAPACITY, z_near=Z_NEAR, z_far=Z_FAR,
              xmap_cache_dir=cache_dir)
    t0 = time.perf_counter()
    eng_p = XMapsDepthEngine.from_calibration(calib, device="cuda", **kw)
    setup_s = time.perf_counter() - t0
    eng_c = XMapsDepthEngine.from_calibration(
        calib, device="cuda", camera_perspective=True, **kw
    )
    log(f"  demonstrator engine setup {setup_s:.2f} s (cold), plan {eng_p.plan}")
    frames = make_frames(calib, N_FRAMES, 0.031)
    n_events = [min(len(ev), CAPACITY) for ev in frames]
    log(f"  {N_FRAMES} frames, events/frame {min(n_events)}..{max(n_events)}")

    # the X-map built on the card equals the CPU build bit for bit
    xm_gpu, _ = build_x_map(
        torch.from_numpy(eng_p.time_map_rect).cuda(),
        x_map_width=eng_p.cfg.x_map_width, t_px_scale=eng_p.cfg.t_px_scale,
        num_scanlines=eng_p.cfg.projector_width,
    )
    xm_cpu, _ = build_x_map(
        torch.from_numpy(eng_p.time_map_rect),
        x_map_width=eng_p.cfg.x_map_width, t_px_scale=eng_p.cfg.t_px_scale,
        num_scanlines=eng_p.cfg.projector_width,
    )
    assert_exact("build_x_map cuda vs cpu", [(xm_gpu, xm_cpu)])
    log(f"  build_x_map {tuple(xm_gpu.shape)}: cuda == cpu exact")

    # -- 3. per-kernel parity ------------------------------------------
    errs: dict = {}
    log("phase 3 kernel parity (card vs plain version on the card, exact):")
    staged = {}
    for name, eng in (("projector", eng_p), ("camera", eng_c)):
        staged[name] = kernel_parity(eng, frames[0], errs)
    torch.cuda.synchronize()

    # -- 4. main path, both views --------------------------------------
    _build.reset_launch_counts()
    out_p = [eng_p.process_frame(ev) for ev in frames]
    out_c = [eng_c.process_frame(ev) for ev in frames]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"phase 4 main path: {N_FRAMES} frames x 2 views, launches {launches}")
    expect = {k: 0 for k in KERNEL_INFO}
    expect.update(event_disparity_scatter=2 * N_FRAMES, tail_projector=N_FRAMES,
                  colorize_camera=N_FRAMES)
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    for name, eng, outs in (("projector", eng_p, out_p), ("camera", eng_c, out_c)):
        cpu = eng.to("cpu")
        for i, (ev, got) in enumerate(zip(frames, outs)):
            assert_exact(f"{name} frame {i} cuda vs cpu",
                         frame_pairs(got, cpu.process_frame(ev)))
            d = got.depth[got.depth > 0]
            med = float(d.median())
            depth_m = 0.45 + 0.02 * i
            if not (torch.isfinite(got.depth).all() and abs(med - depth_m) < 0.05 * depth_m):
                raise AssertionError(f"{name} frame {i}: median depth {med} vs plane {depth_m}")
        log(f"  {name} view: {N_FRAMES} frames bit-equal to the CPU port; "
            f"frame {tuple(outs[0].frame_bgr.shape)}, median depth "
            f"{float(outs[0].depth[outs[0].depth > 0].median()):.4f} m (plane 0.45 m)")

    # -- 5. ESL bench geometry -----------------------------------------
    t0 = time.perf_counter()
    esl = make_synthetic_calibration(640, 480, 1080, 1920)
    esl = dataclasses.replace(esl, rect_image_width=3 * 1080, rect_image_height=3 * 1920)
    eng_e = XMapsDepthEngine.from_calibration(esl, device="cuda", **kw)
    esl_frames = make_frames(esl, 3, 0.031, target=CAPACITY - 1024)
    log(f"phase 5 ESL geometry: rect {esl.rect_image_height}x{esl.rect_image_width}, "
        f"X-map {tuple(eng_e.tables.x_map.shape)}, plan {eng_e.plan}, "
        f"setup {time.perf_counter() - t0:.2f} s")
    esl_errs: dict = {}
    kernel_parity(eng_e, esl_frames[0], esl_errs)
    cpu_e = eng_e.to("cpu")
    for i, ev in enumerate(esl_frames):
        assert_exact(f"ESL frame {i} cuda vs cpu",
                     frame_pairs(eng_e.process_frame(ev), cpu_e.process_frame(ev)))
    log(f"  ESL: {len(esl_frames)} frames bit-equal to the CPU port "
        f"({[len(ev) for ev in esl_frames]} events)")
    for k, v in esl_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    for k, v in phase_filters(card, errs, {"projector": eng_p, "camera": eng_c}, frames,
                              eng_e, esl_frames).items():
        launches[k] += v

    # -- 6. timing -------------------------------------------------------
    # wall: host clock around process_frame + synchronize (staging, H2D,
    # launches, kernels), median of 60 warm frames; device: the profiler's
    # summed device-event time per frame over 48 more frames
    log(f"phase 6 timing {card}:")
    for name, eng, geo_frames in (("projector", eng_p, frames),
                                  ("camera", eng_c, frames),
                                  ("esl_projector", eng_e, esl_frames)):
        w, p90, dev, by_name = time_frames(eng, geo_frames)
        ev_per_frame = statistics.mean(min(len(ev), CAPACITY) for ev in geo_frames)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"  {name}: {w:.4f} ms/frame wall median (p90 {p90:.4f}), {dev:.4f} ms/frame "
            f"device, busy share {dev / w:.3f}; {ev_per_frame / w / 1e3:.2f} Mev/s wall, "
            f"{ev_per_frame / dev / 1e3:.2f} Mev/s device {card}")
        for k, v in top:
            log(f"      {v * 1e3:8.2f} us/frame  {k[:100]}")
    for eng in (eng_p, eng_c):
        time_filters(card, eng, frames)

    kernels_ms = {}
    batch, t_bin, ekw, packed_p = staged["projector"]
    kernels_ms["event_disparity_scatter"] = time_pair(
        lambda: event_disparity_scatter(batch, t_bin, eng_p.tables, **ekw),
        lambda: event_disparity_scatter_plain(batch, t_bin, eng_p.tables, **ekw),
    )
    disp = dict(emit_aux=False, packed_bgr=True)
    kernels_ms["tail_projector"] = time_pair(
        lambda: tail_projector(packed_p, eng_p.tables, eng_p.plan, **disp),
        lambda: tail_projector_plain(packed_p, eng_p.tables, eng_p.plan, **disp),
    )
    packed_c = staged["camera"][3]
    kernels_ms["colorize_camera"] = time_pair(
        lambda: colorize_camera(packed_c, eng_c.tables, eng_c.plan, **disp),
        lambda: colorize_camera_plain(packed_c, eng_c.tables, eng_c.plan, **disp),
    )
    # bounds: this run's inputs (kernel 1: the projector-view frame 0)
    t = eng_p.tables
    shapes = {
        "event_disparity_scatter": (
            batch.capacity, int(batch.valid.sum()),
            t.cam_map_packed.numel() * 4, t.x_map.numel() * 2, packed_p.numel()),
        "tail_projector": (packed_p.numel(), t.proj_mapx_i16.numel()),
        "colorize_camera": (packed_c.numel(),),
    }
    library_ms: dict = {}
    for k, (km, pm) in kernels_ms.items():
        log(f"  kernel {k}: {km['ms']:.5f} ms device ({km['source']}), plain "
            f"{pm['ms']:.5f} ms; issue rate {km['issue_ms']:.5f} vs {pm['issue_ms']:.5f} "
            f"ms/call (demonstrator, display-packed, mean of 2x50 calls) {card}")

    # -- 7-10. the offline eval, the replay app, the benches ------------
    # launches: the engine's main path (phase 4) and the filters' (phase
    # 5b) plus the eval apps' (phase 7), the replay and live app's (phase
    # 8), the bench's (phase 9) and the store-loop bench's (phase 10), each
    # counted from 0 just before its run
    for part in (phase7_offline_eval(card, errs, kernels_ms, shapes, library_ms),
                 phase8_streaming(card, errs),
                 phase9_bench(card, errs, kernels_ms, shapes, library_ms),
                 phase10_store_loop(card, errs, kernels_ms, shapes, library_ms)):
        for k, v in part.items():
            launches[k] += v
    log(f"launches on the main paths (phases 4, 5b, 7, 8, 9, 10): {launches}")

    kernels = []
    for k in KERNEL_INFO:
        bound_ms = kernel_bytes(k, shapes) / HBM_BYTES_PER_S * 1e3
        kernels.append(dict(
            name=k, route="cuda", source=KERNEL_INFO[k][0],
            replaces=KERNEL_INFO[k][1], launches=launches[k],
            max_abs_err=errs[k], ms=kernels_ms[k][0]["ms"],
            plain_ms=kernels_ms[k][1]["ms"], bound_ms=bound_ms, bound_by="bytes",
            library_ms=library_ms.get(k)))
        km = kernels_ms[k][0]
        top = f"; device events of the second, ms a call: {km['top']}" if km["top"] else ""
        log(f"  kernel {k}: {kernels[-1]['ms']:.5f} ms (turns {km['turns'][0]:.5f}, "
            f"{km['turns'][1]:.5f}{top}), "
            f"bound {bound_ms:.6f} ms (bytes), share of bound {bound_ms / kernels[-1]['ms']:.4f},"
            f" library {library_ms.get(k)} ms {card}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
