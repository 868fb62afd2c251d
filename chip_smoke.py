#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (xmaps_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Builds the three CUDA kernels from xmaps_tpu_torch/csrc/ with nvcc, checks
each against its plain PyTorch version on the card, drives the engine's
main path (XMapsDepthEngine.from_calibration -> process_frame) at the
paper's demonstrator geometry in both views and at the ESL bench geometry,
checks every frame bit for bit against the port on the CPU with the same
tables, times frames and kernels with CUDA events, and prints one JSON
line per kernel summary plus a last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any mismatch or error raises: there is no fallback and no caught phase.

Tolerances: every integer, u8 and float32 output is compared exactly
(max_abs_err must be 0).  The one plausibility bound is the recovered
plane depth, within 5% of the simulated plane (the depth formula neglects
the rectification rotation and disparities are whole pixels).
"""

from __future__ import annotations

import dataclasses
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
}
N_FRAMES = 12
CAPACITY = 28 * 1024
Z_NEAR, Z_FAR = 0.2, 1.2


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


def kernel_parity(eng, ev, errs):
    """Phase 3: each kernel against its plain version on the card, on the
    shapes the engine's main path gives it."""
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
    from xmaps_tpu_torch.ops.disparity import scale_time

    cfg, plan, tables = eng.cfg, eng.plan, eng.tables
    batch = eng.make_batch(ev)
    t_bin = scale_time(batch.t, batch.valid, cfg.t_px_scale)
    if cfg.camera_perspective:
        kw = dict(camera_view=True, window=(0, 0),
                  out_shape=(cfg.camera_height, cfg.camera_width))
        tail, tail_plain, tail_name = colorize_camera, colorize_camera_plain, "colorize_camera"
    else:
        kw = dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
                  out_shape=(plan.H, plan.W))
        tail, tail_plain, tail_name = tail_projector, tail_projector_plain, "tail_projector"
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
    """(device ms per call, how it was measured, CUDA-event ms per call):
    the profiler's device time, or the CUDA-event time where the profiler
    recorded nothing."""
    dev, _ = profile_calls(fn, iters)
    ev = time_events(fn, iters)
    return (dev, "profiler", ev) if dev is not None else (ev, "cuda_events", ev)


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
        return dict(ms=(a[0] + b[0]) / 2, source=a[1], issue_ms=(a[2] + b[2]) / 2)

    return mean(k1, k2), mean(p1, p2)


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
    expect = {"event_disparity_scatter": 2 * N_FRAMES,
              "tail_projector": N_FRAMES, "colorize_camera": N_FRAMES}
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

    # -- 6. timing -------------------------------------------------------
    # wall: host clock around process_frame + synchronize (staging, H2D,
    # launches, kernels), median of 60 warm frames; device: the profiler's
    # summed device-event time per frame over 48 more frames
    log(f"phase 6 timing {card}:")
    for name, eng, geo_frames in (("projector", eng_p, frames),
                                  ("camera", eng_c, frames),
                                  ("esl_projector", eng_e, esl_frames)):
        for ev in geo_frames:
            eng.process_frame(ev, display_only=True, display_packed=True)
        torch.cuda.synchronize()
        wall = []
        for i in range(60):
            ev = geo_frames[i % len(geo_frames)]
            t0 = time.perf_counter()
            eng.process_frame(ev, display_only=True, display_packed=True)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        it = itertools.cycle(geo_frames)
        dev, by_name = profile_calls(
            lambda: eng.process_frame(next(it), display_only=True, display_packed=True), 48
        )
        if dev is None:
            raise AssertionError("torch.profiler recorded no device event for a frame")
        ev_per_frame = statistics.mean(min(len(ev), CAPACITY) for ev in geo_frames)
        w = statistics.median(wall)
        p90 = statistics.quantiles(wall, n=10)[-1]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"  {name}: {w:.4f} ms/frame wall median (p90 {p90:.4f}), {dev:.4f} ms/frame "
            f"device, busy share {dev / w:.3f}; {ev_per_frame / w / 1e3:.2f} Mev/s wall, "
            f"{ev_per_frame / dev / 1e3:.2f} Mev/s device {card}")
        for k, v in top:
            log(f"      {v * 1e3:8.2f} us/frame  {k[:100]}")

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
    for k, (km, pm) in kernels_ms.items():
        log(f"  kernel {k}: {km['ms']:.5f} ms device ({km['source']}), plain "
            f"{pm['ms']:.5f} ms; issue rate {km['issue_ms']:.5f} vs {pm['issue_ms']:.5f} "
            f"ms/call (demonstrator, display-packed, mean of 2x50 calls) {card}")

    kernels = [
        dict(name=k, route="cuda", source=KERNEL_INFO[k][0],
             replaces=KERNEL_INFO[k][1], launches=launches[k],
             max_abs_err=errs[k], ms=kernels_ms[k][0]["ms"],
             plain_ms=kernels_ms[k][1]["ms"])
        for k in KERNEL_INFO
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
