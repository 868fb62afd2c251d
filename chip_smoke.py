#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (xmaps_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Builds the ten CUDA kernels (and the group entries of kernels 1, 2, 3
and F) from xmaps_tpu_torch/csrc/ with nvcc (one
process a source, started together), checks each against its plain PyTorch
version on the card (the per-engine colorize table that kernels 2 and 3 read
against the plain epilogue of all 8192 disparities, bit for bit), and drives
the port's paths:

- the per-frame engine (XMapsDepthEngine.from_calibration -> process_frame)
  at the paper's demonstrator geometry in both views and at the ESL bench
  geometry (phases 3-6), every frame checked bit for bit against the port
  on the CPU with the same tables; phase 3 also holds kernel 1's staged
  entry (the 1-word batch of the segmented streaming path) and its ring
  entry (the frame read from k = 1, 4, 8 rows of the packet ring, partial
  first and last packets, words with bit 31 set, a frame over the
  capacity) against their plain versions, and phase 6 checks that no fill
  runs beside kernel 1 (it zeroes its map inside its cooperative launch),
  times the staged and ring entries, and times the engine's dispatch from
  the trigger on, ``process_ring`` against ``process_staged``, in turns;
- ``process_frames`` as one program (phase 4b): kernel 1's group entries
  (the group's 1-word rows and device counts, the stacked arrays with and
  without a priority) and the tail's group entries against their plain
  versions, then ``process_frames`` of the 12 demonstrator frames in both
  views, of the ESL frames and of the 12 frames with a dedup filter, one
  launch of kernel 1 and one of the tail a group, every element bit-equal
  to ``process_frame`` on the card and to the CPU port; phase 6 times the
  group against the per-frame loop (device and wall ms a frame, in turns)
  and each group entry against its plain version, and kernels 1 and 2 at
  the ESL rig (one frame and a group of 12, L2 flushed) beside the
  demonstrator's;
- scale-out on a virtual mesh of the one card (phase 4c): ``cuda:0``
  listed data x event times, ``parallel.make_sharded_pipeline`` of the 12
  demonstrator frames at (data, event) = (2, 1), (4, 1), (1, 2), (1, 4),
  (2, 2) in both views, of the ESL frames at (1, 2) and of the 12 frames
  with ``first_per_xy`` at (2, 2), then ``process_frames_sharded`` of 12
  and of 7 frames at data 4: one kernel 1 group launch a mesh device and
  one tail group call a data row, every element bit-equal to
  ``process_frame`` on the card and to the CPU port; phase 3 holds kernel
  1's lane offset (``index_offset``) against its plain version, phase 6
  times it against offset 0 and prints ``apps.bench_scaling --virtual 4``'s
  line (each mesh shape's wall and device ms a frame), and phase 7 runs
  ``apps.eval_xmaps.run_sharded`` (``-devices N``'s loop) on a virtual
  mesh of 2, its depth ``.npy`` byte-equal to ``-devices 1``'s;
- the five dedup frame filters (phase 5b): kernel F (``frame_dedup_filter``,
  which replaces the JAX package's XLA stage ``apply_frame_filter``) and
  its group entry against their plain version on the card (the keep mask
  and the time bit-equal, the priority each survivor's rank by the plain
  version's dense rank, so order-equal over the survivors, and below the
  capacity) on the demonstrator frames, their group of 12, the ESL frames,
  the ESL frames' events as one frame of more lanes than the main path's
  capacity (and a group of 2 such) and frames with events outside the
  camera; kernel 1 with each filter's
  scatter priority against its plain version, then ``set_frame_filter``
  and the 12 demonstrator frames in both views for each of the four dedup
  filters, and ``first_per_yt`` (the largest key space) on 3 frames at the
  ESL geometry, every frame bit-equal to the CPU port and one kernel F
  launch a frame, then each filter on frames with events outside the
  camera (no device-side assert, bit-equal to the CPU port); phase 6 times
  each filter (wall and device ms a frame, kernel F against its plain
  version on the card, and the group entry on the 12 frames);
- the offline evaluation at the ESL geometry (phase 7): the four eval apps
  (ESL init + refine, MC3D, X-maps, table) through their ``main`` on 4
  synthetic plane scans, with kernels A and B (ESL search, static remap)
  held against their plain versions and the brute force, kernel R (ESL's
  refinement at W = 7) against its plain version on one scan and a group
  of 12, exactly, and timed beside it, and the outputs against the port on
  the CPU; kernel A's bound counts the distinct table
  elements its search reads on the scan (``esl_table_elements``), kernel
  3's the table entries of the distinct disparities in its map
  (``distinct_disparities``);
- the streaming replay app (phase 8): ``apps.depth_reprojection.main`` on a
  60-frame EVT3 recording of the demonstrator rig (1 s at 60 Hz, ~28k
  events a frame, blanking gaps), in both views, through the pipe's
  default packet-ring prestaging (every frame from the ring: no ring
  fallback, no overrun) and once with ``prestage=False`` (segmented
  staging), every frame the pipe computed checked bit for bit against the
  CPU port's ``process_staged`` of the same segmented events and the ring
  replay against the segmented one, and the 2-word staging against the
  ring's frames on the card; one replay with a dedup filter selected
  through the processor's E key; then trigger -> frame-ready latency,
  replay frames/s, ingest Mev/s, the pinned H2D time and the busy share
  from a profiled ring and a profiled segmented replay (the segmented
  trace's H2D copies each straight into kernel 1; the ring trace's at most
  one a staged packet), and (``chip_smoke.py --staged-order RAW``, a
  process of its own) one H2D copy a segmented frame, each straight into
  kernel 1, and no H2D copy at all from a ring frame's dispatch to its
  kernel 1;
  then live capture: the app without ``--input`` on the wall-clock-paced
  ``synthetic`` camera for about 1 s each, with the PNG file sink (by
  default and with ``--low-latency``) and headless, every computed frame
  bit-equal to the CPU port, at least as many frames as the watchdog lets
  through at the run's measured host cost (``live_frame_floor``), with the
  trigger -> frame-ready latency, the stream lag and the host's stage
  timers (``prestage packet`` among the per-packet ones) under a paced
  stream;
- the engine benchmark (phase 9): kernel W (the warm-up) against its plain
  version, then one run of ``apps.bench``, one of ``apps.bench_geometry
  --geometry esl`` a view (the paper's Table-2 rig: 12 frames pre-staged as
  one display-packed group a call; then the bench's group held against
  the CPU port, a list of mixed integer and float timestamps through
  ``process_frames``, and the group profiled) and one of
  ``apps.bench_stream`` (the streaming latency of the ring and of
  segmented staging), whose JSON lines are printed;
- the scatter-store micro-benchmark (phase 10): kernel S (last-write-wins
  stores into one tile held by one 16-block thread-block cluster) against
  its plain version, on a tile several clusters share too, then one run of
  ``apps.bench_store_loop``,
  whose JSON line is printed and gives kernel S's times (kernel, plain
  version, ``index_put_``);
- the measurement tools (phase 11): ``apps.check_bitexact --geometry
  both`` (every frame entry on the card bit-equal to the CPU port, 0
  failures), ``apps.profile_trace`` at both rigs in both views (a group of
  12, its kernel events equal to the launches counted), ``apps.profile_stages``,
  ``apps.profile_setup`` (warm, in a process of its own),
  ``apps.bench_esl_init`` and ``apps.profile_esl_init``, whose JSON lines
  are printed.

It times frames, scans and kernels (torch.profiler device time and wall
time; kernel 2 ``tail_projector`` is two launches, the column-strip dilate
and the remap through the colorize table, timed together and listed apart) and prints one JSON line with every kernel's launches on the main
paths, error, time, plain and library time and bound (phase 6 also holds
kernels 2 and 3 against the nearest library calls: ``F.max_pool2d`` for the
dilate half, ``torch.index_select`` through the colorize table), then the card's name
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

import collections
import contextlib
import cProfile
import dataclasses
import functools
import io
import itertools
import json
import os
import pstats
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
    # kernel 3's per-engine table: the epilogue of pallas_colorize's body
    "colorize_table": (
        "xmaps_tpu_torch/csrc/tail.cu",
        "xmaps_tpu/ops/pallas_tail.py:736",
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
    # the group entries (process_frames: F frames in one call of each)
    "event_disparity_scatter_group": (
        "xmaps_tpu_torch/csrc/events.cu",
        "xmaps_tpu/ops/pallas_events.py:508",
    ),
    "tail_projector_group": (
        "xmaps_tpu_torch/csrc/tail.cu",
        "xmaps_tpu/ops/pallas_tail.py:851",
    ),
    "colorize_camera_group": (
        "xmaps_tpu_torch/csrc/tail.cu",
        "xmaps_tpu/ops/pallas_tail.py:777",
    ),
    # kernel F, the dedup frame filters: it replaces an XLA stage of the
    # JAX package, which has no Pallas kernel there
    "frame_dedup_filter": (
        "xmaps_tpu_torch/csrc/filters.cu",
        "xmaps_tpu/ops/filters.py:83 (XLA stage, not a TPU kernel)",
    ),
    "frame_dedup_filter_group": (
        "xmaps_tpu_torch/csrc/filters.cu",
        "xmaps_tpu/ops/filters.py:83 (XLA stage, not a TPU kernel)",
    ),
    # kernel R, ESL's refinement: the JAX package's is plain XLA, no Pallas
    # kernel; added because the plain version's launches made the ESL
    # ground truth host-bound
    "esl_refine": (
        "xmaps_tpu_torch/csrc/esl_refine.cu",
        "xmaps_tpu/apps/eval_esl.py:144 (XLA, not a TPU kernel)",
    ),
}
#: H100 SXM memory rate (NVIDIA data sheet), bytes/s: every kernel here but
#: kernel R moves far more bytes than it does operations, so its bound is bytes
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM FP32 instructions a second outside the tensor cores: 132 SMs x
#: 128 lanes x 1.98 GHz (the data sheet's 67 TFLOP/s counts an FMA as two);
#: kernel R's bound (it rounds every operation apart: no FMA)
FP32_OPS_PER_S = 132 * 128 * 1.98e9
#: kernel R's FP32 adds, multiplies and divisions (csrc/esl_refine.cu): a
#: cost evaluation (the rays times rho 2, the rigid motion 18, two
#: divisions, r2 3, the radial term 6, the distorted u and v 9 each, the
#: pixel 4, the scan time 1, the quadratic 6) and its sample (2); a pixel's
#: stencil sums, 5 a tap, and its other set-up (base 3, the range 4, each
#: grid's step and start 3)
ESL_REFINE_OPS_A_SAMPLE = 2 + 18 + 2 + 3 + 6 + 9 + 9 + 4 + 1 + 6 + 2
ESL_REFINE_OPS_A_TAP = 5
ESL_REFINE_OPS_A_PIXEL = 3 + 4 + 2 * 3
#: the largest share of its bound a kernel's time may show (1, and the
#: timing's noise): a larger one means a bound that does not bound
MAX_SHARE = 1.05
N_FRAMES = 12
CAPACITY = 28 * 1024
#: phase 4c: the (data, event) shapes of the virtual meshes of the one card
MESH_SHAPES = ((2, 1), (4, 1), (1, 2), (1, 4), (2, 2))
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
#: host seconds of untimed calls on each side of a profiled window
#: (device_events)
PROFILE_PAD_S = 0.02
#: the plain versions' calls a turn in phase 6's cold group and ESL timings
#: (each is a host loop of many torch ops: 10 calls time it well, 50 took
#: most of the phase)
COLD_PLAIN_ITERS = 10
#: bytes written between the calls of a cold timing (cold_device_ms)
L2_FLUSH_BYTES = 256 << 20


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


def kernel_parity(eng, ev, errs, frames=None):
    """Phase 3: each kernel against its plain version on the card, on the
    shapes the engine's main path gives it (kernel 1's staged entry too, and
    with ``frames`` its ring entry)."""
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter,
        event_disparity_scatter_plain,
    )
    from xmaps_tpu_torch.ops.disparity import scale_time

    cfg, plan, tables = eng.cfg, eng.plan, eng.tables
    batch = eng.make_batch(ev)
    t_bin = scale_time(batch.t, batch.valid, cfg.t_px_scale)
    kw, tail, tail_plain, tail_name = view_kwargs(eng)
    view = "camera" if kw["camera_view"] else "projector"
    ref = event_disparity_scatter_plain(batch, t_bin, tables, want_lanes=True, **kw)
    got = event_disparity_scatter(batch, t_bin, tables, want_lanes=True, **kw)
    err = assert_exact(
        f"event_disparity_scatter ({view} view)",
        [(got.packed_map, ref.packed_map), (got.num_inliers, ref.num_inliers)]
        + list(zip(got.lanes, ref.lanes)),
    )
    errs["event_disparity_scatter"] = max(errs.get("event_disparity_scatter", 0.0), err)
    log(f"  event_disparity_scatter {kw['out_shape']} n={batch.capacity} "
        f"inliers={int(got.num_inliers)}: exact")
    offset_parity(eng, ev, frames, kw, errs)
    staged_parity(eng, ev, kw, errs)
    if frames is not None:
        ring_parity(eng, frames, kw, errs)
    table_parity(eng, errs)
    for opts in (dict(emit_aux=True, packed_bgr=False),
                 dict(emit_aux=False, packed_bgr=False),
                 dict(emit_aux=False, packed_bgr=True)):
        a = tail(ref.packed_map, tables, plan, **opts)
        b = tail_plain(ref.packed_map, tables, plan, **opts)
        err = assert_exact(f"{tail_name} {opts}", list(zip(a, b)))
        errs[tail_name] = max(errs.get(tail_name, 0.0), err)
        log(f"  {tail_name} {opts} -> {tuple(a[0].shape)}: exact")
    return batch, t_bin, kw, ref.packed_map


def offset_parity(eng, ev, frames, kw, errs):
    """Phase 3: kernel 1's array entry with a lane offset (``index_offset``:
    an event shard's first lane in its frame) against its plain version on
    the card, exact, at offset 0 (equal to the entry without one), at the
    (1, 2) mesh's second shard's (capacity / 2) and at the largest the
    packing holds (keys past 2**31); with ``frames``, the array group
    entry on the frames' second lane half, binned with the whole frames'
    bounds, as the event axis runs it."""
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter,
        event_disparity_scatter_group,
        event_disparity_scatter_group_plain,
        event_disparity_scatter_plain,
    )
    from xmaps_tpu_torch.ops.disparity import scale_time, time_bounds
    from xmaps_tpu_torch.ops.event_batch import EventBatch
    from xmaps_tpu_torch.ops.scatter import MAX_CAPACITY

    cap, scale = eng.cfg.event_capacity, eng.cfg.t_px_scale
    batch = eng.make_batch(ev)
    t_bin = scale_time(batch.t, batch.valid, scale)
    offsets = (0, cap // 2, MAX_CAPACITY - cap)
    err, high = 0.0, False
    for off in offsets:
        got = event_disparity_scatter(batch, t_bin, eng.tables, index_offset=off, **kw)
        ref = event_disparity_scatter_plain(batch, t_bin, eng.tables, index_offset=off, **kw)
        err = max(err, assert_exact(f"event_disparity_scatter index_offset {off}", [
            (got.packed_map, ref.packed_map), (got.num_inliers, ref.num_inliers)]))
        high |= bool((got.packed_map < 0).any())
    assert_exact("event_disparity_scatter index_offset 0 vs no offset", [
        (event_disparity_scatter(batch, t_bin, eng.tables, index_offset=0, **kw).packed_map,
         event_disparity_scatter(batch, t_bin, eng.tables, **kw).packed_map)])
    if not high:
        raise AssertionError("index_offset parity: no word of 2**31 or above")
    errs["event_disparity_scatter"] = max(errs.get("event_disparity_scatter", 0.0), err)
    what = f"offsets {offsets}"
    if frames is not None:
        group = EventBatch.stack_structured(frames, cap, device="cuda")
        bounds = time_bounds(group.t, group.valid)
        half = slice(cap // 2, cap)
        shard = EventBatch(*(a[:, half].contiguous() for a in group[:5]), count=group.count)
        tb = scale_time(shard.t, shard.valid, scale, bounds=bounds)
        got = event_disparity_scatter_group(shard, tb, eng.tables, index_offset=cap // 2, **kw)
        ref = event_disparity_scatter_group_plain(shard, tb, eng.tables,
                                                  index_offset=cap // 2, **kw)
        e = assert_exact("event_disparity_scatter_group index_offset (the second lane half)",
                         [(got.packed_map, ref.packed_map), (got.num_inliers, ref.num_inliers)])
        errs["event_disparity_scatter_group"] = max(
            errs.get("event_disparity_scatter_group", 0.0), e)
        what += f"; group entry on {len(frames)} frames' lanes [{cap // 2}, {cap})"
    log(f"  event_disparity_scatter index_offset ({what}; words past 2**31): exact")


def table_parity(eng, errs):
    """The colorize table kernels 2 and 3 read, built on the card with the
    engine (either view), against the plain epilogue of all PACK
    disparities, bit for bit."""
    import torch
    from xmaps_tpu_torch.ops.cuda_tail import colorize_table_plain

    bgr, depth = eng.plan.table
    ref_bgr, ref_depth = colorize_table_plain(eng.tables, eng.plan)
    err = assert_exact("colorize_table (BGR, depth bits) vs the plain epilogue",
                       [(bgr, ref_bgr), (depth.view(torch.int32), ref_depth.view(torch.int32))])
    errs["colorize_table"] = max(errs.get("colorize_table", 0.0), err)
    log(f"  colorize_table: all {bgr.numel()} disparities bit-equal to the plain epilogue "
        f"(p03 {eng.plan.p03:.4f}, {len(torch.unique(bgr))} distinct colours)")


def staged_parity(eng, ev, kw, errs):
    """Phase 3: kernel 1's staged entry (1-word batch, host count) against
    its plain version on the card, at a count below the capacity and at
    count 0; and its plain version against the
    array entry's on the same events."""
    from xmaps_tpu_torch.io.prefetch import HostStagingPool
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter_plain,
        event_disparity_scatter_staged,
        event_disparity_scatter_staged_plain,
    )
    from xmaps_tpu_torch.ops.disparity import scale_time

    cap, layout = eng.cfg.event_capacity, eng.compact_layout
    pool = HostStagingPool(cap, device="cuda", layout=layout)
    err, counts = 0.0, []
    for evs in (ev[: min(len(ev), cap - 1000)], ev[:0]):
        staged = pool.stage_compact(evs)
        counts.append(staged.count)
        ref = event_disparity_scatter_staged_plain(staged.word, staged.count, layout,
                                                   eng.tables, **kw)
        got = event_disparity_scatter_staged(staged.word, staged.count, layout, eng.tables, **kw)
        err = max(err, assert_exact(
            f"event_disparity_scatter_staged count {staged.count}",
            [(got.packed_map, ref.packed_map), (got.num_inliers, ref.num_inliers)]))
        batch = eng.make_batch(evs)
        arr = event_disparity_scatter_plain(
            batch, scale_time(batch.t, batch.valid, eng.cfg.t_px_scale), eng.tables, **kw)
        assert_exact(f"staged vs array entry, count {staged.count}",
                     [(ref.packed_map, arr.packed_map), (ref.num_inliers, arr.num_inliers)])
    errs["event_disparity_scatter"] = max(errs.get("event_disparity_scatter", 0.0), err)
    log(f"  event_disparity_scatter_staged at counts {counts} of {cap} (layout "
        f"{tuple(layout)[:3]} bits): exact; == the array entry")


def ring_parity(eng, frames, kw, errs):
    """Phase 3: kernel 1's ring entry (the frame read from k rows of the
    1-word packet ring) against its plain version on the card, exact, over
    memory that held garbage: k = 1, 4 and 8 packets of 6 ms (t_rel past
    4096 us sets bit 31 of the 10 + 9 + 13-bit word), the frame starting
    inside the first packet and ending inside the last, and 8 packets of
    two frames' events, over the capacity."""
    import torch
    from xmaps_tpu_torch.io.prefetch import PacketRing
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter_ring,
        event_disparity_scatter_ring_plain,
    )
    from xmaps_tpu_torch.utils.synthetic import as_arrival_packets

    cfg, layout = eng.cfg, eng.ring_layout
    rng = np.random.default_rng(17)
    err, cases = 0.0, []
    for k, ev in ((1, frames[0]), (4, frames[1]), (8, frames[2]),
                  (8, np.concatenate(frames[3:5]))):
        ev, packets = as_arrival_packets(ev, k, 6000, rng)
        ring = PacketRing(packet_capacity=max(len(p) for p in packets), n_slots=16,
                          device="cuda", layout=layout)
        for packet in packets:
            if not ring.stage_packets(packet):
                raise AssertionError("ring overrun in phase 3")
        gs, ge = int(rng.integers(1, 500)), len(ev) - int(rng.integers(1, 500))
        frame = ev[gs:ge]
        pkts, meta, t_bounds = ring.frame(gs, frame, cfg.event_capacity)
        count = min(len(frame), cfg.event_capacity)
        args = (tuple(p.xy for p in pkts), meta, count, t_bounds, layout, eng.tables)
        junk = torch.full((kw["out_shape"][0] * kw["out_shape"][1] + 64,), -1,
                          dtype=torch.int32, device="cuda")
        del junk
        got = event_disparity_scatter_ring(*args, t_px_scale=cfg.t_px_scale, **kw)
        ref = event_disparity_scatter_ring_plain(*args, t_px_scale=cfg.t_px_scale, **kw)
        err = max(err, assert_exact(
            f"event_disparity_scatter_ring k={k} count {count}",
            [(got.packed_map, ref.packed_map), (got.num_inliers, ref.num_inliers)]))
        cases.append((len(pkts), count, len(frame), bool((ring.rows["xy"] < 0).any()),
                      int(got.num_inliers)))
    if not (cases[-1][1] == cfg.event_capacity < cases[-1][2] and all(c[3] for c in cases)
            and all(c[4] > 1000 for c in cases)):
        raise AssertionError(f"ring parity cases (k, count, frame events, bit 31, inliers): "
                             f"{cases}")
    errs["event_disparity_scatter"] = max(errs.get("event_disparity_scatter", 0.0), err)
    log(f"  event_disparity_scatter_ring (k, count, frame events, bit 31 set, inliers) {cases} "
        f"(layout {tuple(layout)}): exact")


def ring_of_frames(eng, frames):
    """The frames as the pipe's ring holds them: each frame's events as 4
    arrival packets (its time quarters), staged into one 1-word ring on the
    card with room for all (rows of the pipe's size, so a long quarter
    splits); per frame (packets, meta, time bounds)."""
    from xmaps_tpu_torch.io.prefetch import PacketRing

    cap = eng.cfg.event_capacity
    ring = PacketRing(packet_capacity=max(2048, cap // 4), n_slots=16 * len(frames),
                      device="cuda", layout=eng.ring_layout)
    out, base = [], 0
    for ev in frames:
        t = ev["t"]
        cuts = np.searchsorted(t, t[0] + (int(t[-1]) - int(t[0]) + 1) * np.arange(5) // 4)
        for a, b in zip(cuts[:-1], cuts[1:]):
            if b > a and not ring.stage_packets(ev[a:b]):
                raise AssertionError("ring overrun")
        args = ring.frame(base, ev, cap)
        if args is None:
            raise AssertionError("a frame spans more than RING_SLOTS_PER_FRAME packets")
        out.append(args)
        base += len(ev)
    return ring, out


def filter_batch(eng, batch, name):
    """The dedup filter ``name`` on ``batch``, as ``depth_frame`` runs it."""
    from xmaps_tpu_torch.ops.frame_pipeline import filter_events

    return filter_events(batch, eng.tables, eng.cfg.replace(frame_filter=name))


def survivor_rank(prio, keep):
    """Each survivor's rank among its frame's survivors by ``prio`` (the
    plain version's dense rank), 0 for a dropped lane: kernel F's
    priority.  Each row of a (F, N) group on its own."""
    import torch

    if prio.dim() == 2:
        return torch.stack([survivor_rank(p, k) for p, k in zip(prio, keep)])
    out = torch.zeros_like(prio)
    idx = keep.nonzero().flatten()
    out[idx[torch.argsort(prio[idx])]] = torch.arange(len(idx), dtype=prio.dtype,
                                                      device=prio.device)
    return out


def dedup_parity(what, eng, batch, errs, names=None):
    """Kernel F (``apply_frame_filter``, or its group entry on a stacked
    batch) against its plain version on the card, for each dedup filter
    in ``names``: the keep mask and the time exact, the priority equal to
    ``survivor_rank`` of the plain priority (so it orders the survivors as
    the plain version does) and below the capacity."""
    from xmaps_tpu_torch.ops.filters import (
        FILTER_NAMES,
        apply_frame_filter,
        apply_frame_filter_group,
        apply_frame_filter_group_plain,
        apply_frame_filter_plain,
        lut_rectified_x,
    )

    group = batch.x.dim() == 2
    entry = "frame_dedup_filter_group" if group else "frame_dedup_filter"
    apply, plain = ((apply_frame_filter_group, apply_frame_filter_group_plain) if group
                    else (apply_frame_filter, apply_frame_filter_plain))
    cfg, lut = eng.cfg, eng.tables.cam_map_packed
    kw = dict(camera_width=cfg.camera_width, camera_height=cfg.camera_height,
              rect_width=cfg.rect_width)
    survivors = {}
    for name in names or FILTER_NAMES[1:]:
        got = apply(batch, None, name=name, cam_lut=lut, **kw)
        xr = lut_rectified_x(batch.x, batch.y, lut) if name == "first_per_yt" else None
        want = plain(batch, xr, name=name, **kw)
        keep = want.batch.valid
        err = assert_exact(f"{entry} {name} {what}", [
            (got.batch.valid, keep), (got.batch.t, want.batch.t),
            (got.scatter_priority, survivor_rank(want.scatter_priority, keep))])
        if int(got.scatter_priority.max()) >= batch.capacity:
            raise AssertionError(f"{entry} {name} {what}: a priority at or over the capacity")
        errs[entry] = max(errs.get(entry, 0.0), err)
        survivors[name] = int(keep.sum())
    log(f"  {entry} {what} {tuple(batch.x.shape)} vs its plain version: keep and t exact, "
        f"priority = the survivors' rank; survivors {survivors}")


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
    from xmaps_tpu_torch.ops.event_batch import EventBatch
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES
    from xmaps_tpu_torch.utils.synthetic import with_events_outside_camera

    log("phase 5b dedup frame filters:")
    eng = engines["projector"]
    cap = eng.cfg.event_capacity
    dedup_parity("demonstrator frame 0", eng, eng.make_batch(frames[0]), errs)
    dedup_parity(f"demonstrator, {len(frames)} frames", eng,
                 EventBatch.stack_structured(frames, cap, device="cuda"), errs)
    dedup_parity("ESL frame 0", eng_e, eng_e.make_batch(esl_frames[0]), errs,
                 names=["first_per_yt"])
    dedup_parity(f"ESL, {len(esl_frames)} frames", eng_e,
                 EventBatch.stack_structured(esl_frames, cap, device="cuda"), errs,
                 names=["first_per_yt"])
    # more lanes than the main path's capacity: the ESL frames' events as
    # one frame (and a group of 2)
    long = np.concatenate(esl_frames)
    wide = EventBatch.stack_structured([long, long[::2]], len(long), device="cuda")
    if len(long) <= cap:
        raise AssertionError(f"{len(long)} lanes: not past the capacity {cap}")
    dedup_parity(f"ESL, its {len(esl_frames)} frames as one", eng_e, wide.frame(0), errs)
    dedup_parity(f"ESL, its {len(esl_frames)} frames as one, and half of them", eng_e, wide,
                 errs)
    outside = [with_events_outside_camera(ev[: cap - 2000], np.random.default_rng(i),
                                          eng.cfg.camera_width, eng.cfg.camera_height, n=200)
               for i, ev in enumerate(frames[:3])]
    dedup_parity("frame with events outside the camera", eng, eng.make_batch(outside[0]), errs)
    dedup_parity("frames with events outside the camera", eng,
                 EventBatch.stack_structured(outside, cap, device="cuda"), errs)
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
    want.update(event_disparity_scatter=2 * n + n_e, tail_projector=n + n_e, colorize_camera=n,
                frame_dedup_filter=2 * n + n_e)
    if launches != want:
        raise AssertionError(f"filter launches {launches} != {want}")
    log(f"  launches {launches} {card}")
    filters_out_of_camera(engines, frames[:3])
    return launches


def group_parity(eng, frames, errs):
    """Phase 4b: kernel 1's group entries (the staged rows of the group's
    one buffer, and the stacked arrays with and without a priority) and the
    view's tail group entry against their plain versions on the card, on
    the group the main path gives them.  Returns (the staged group, kernel
    1's staged group result)."""
    import torch
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter_group,
        event_disparity_scatter_group_plain,
        event_disparity_scatter_staged_group,
        event_disparity_scatter_staged_group_plain,
    )
    from xmaps_tpu_torch.ops.cuda_tail import (
        colorize_camera_group,
        colorize_camera_group_plain,
        tail_projector_group,
        tail_projector_group_plain,
    )
    from xmaps_tpu_torch.ops.disparity import scale_time
    from xmaps_tpu_torch.ops.event_batch import EventBatch

    kw, _, _, tail_name = view_kwargs(eng)
    tail, tail_plain = ((colorize_camera_group, colorize_camera_group_plain)
                        if kw["camera_view"] else (tail_projector_group, tail_projector_group_plain))
    cap, layout, tables = eng.cfg.event_capacity, eng.compact_layout, eng.tables
    staged = eng.stage_group(frames)
    got = event_disparity_scatter_staged_group(staged, layout, tables, **kw)
    ref = event_disparity_scatter_staged_group_plain(staged, layout, tables, **kw)
    err = assert_exact("event_disparity_scatter_staged_group",
                       [(got.packed_map, ref.packed_map), (got.num_inliers, ref.num_inliers)])
    batch = EventBatch.stack_structured(frames, cap, device="cuda")
    t_bin = scale_time(batch.t, batch.valid, eng.cfg.t_px_scale)
    prio = torch.from_numpy(np.random.default_rng(17).integers(
        0, cap, (len(frames), cap), dtype=np.int32)).cuda()
    for p in (None, prio):
        a = event_disparity_scatter_group(batch, t_bin, tables, priority=p, **kw)
        b = event_disparity_scatter_group_plain(batch, t_bin, tables, priority=p, **kw)
        err = max(err, assert_exact(
            f"event_disparity_scatter_group (priority {p is not None})",
            [(a.packed_map, b.packed_map), (a.num_inliers, b.num_inliers)]))
    assert_exact("kernel 1's staged group entry vs its array group entry",
                 [(got.packed_map, event_disparity_scatter_group(
                     batch, t_bin, tables, **kw).packed_map)])
    errs["event_disparity_scatter_group"] = max(
        errs.get("event_disparity_scatter_group", 0.0), err)
    for opts in (dict(emit_aux=True, packed_bgr=False),
                 dict(emit_aux=False, packed_bgr=False),
                 dict(emit_aux=False, packed_bgr=True)):
        e = assert_exact(f"{tail_name}_group {opts}", list(zip(
            tail(got.packed_map, tables, eng.plan, **opts),
            tail_plain(got.packed_map, tables, eng.plan, **opts))))
        errs[tail_name + "_group"] = max(errs.get(tail_name + "_group", 0.0), e)
    log(f"  group entries, {len(frames)} frames {tuple(got.packed_map.shape)}: kernel 1 staged "
        f"and array (with and without a priority), {tail_name}_group in 3 modes: exact")
    return staged, got


def phase4b_group(card, errs, engines, frames, eng_e, esl_frames):
    """Phase 4b: ``process_frames`` as one program.  The group entries
    against their plain versions (``group_parity``), then the main path:
    ``process_frames`` of the 12 demonstrator frames in both views, of the
    ESL frames, and of the 12 frames with a dedup filter (the array
    layout), every element bit-equal to ``process_frame`` on the card and
    to the CPU port; one launch of kernel 1 and one of the tail a group.
    Returns (the main path's launches, counted from 0 just before it and
    read just after; the staged groups and kernel 1's results by view)."""
    import torch
    from xmaps_tpu_torch.ops import _build

    log("phase 4b process_frames as one program:")
    groups = {view: group_parity(eng, frames, errs) for view, eng in engines.items()}
    torch.cuda.synchronize()
    runs = [(view, eng, frames, "none") for view, eng in engines.items()]
    runs += [("esl_projector", eng_e, esl_frames, "none"),
             ("projector", engines["projector"], frames, "first_per_xy")]
    _build.reset_launch_counts()
    outs = []
    for _, eng, fr, name in runs:
        eng.set_frame_filter(name)
        outs.append(eng.process_frames(fr))
        eng.set_frame_filter("none")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = {k: 0 for k in launches}
    want.update(event_disparity_scatter_group=len(runs), tail_projector_group=len(runs) - 1,
                colorize_camera_group=1,
                frame_dedup_filter_group=sum(name != "none" for *_, name in runs))
    if launches != want:
        raise AssertionError(f"process_frames launches {launches} != {want}")
    for (view, eng, fr, name), got in zip(runs, outs):
        eng.set_frame_filter(name)
        cpu = eng.to("cpu")
        packed = eng.process_frames(fr, display_only=True, display_packed=True)
        for i, ev in enumerate(fr):
            one = eng.process_frame(ev)
            assert_exact(f"{view} {name} group frame {i} vs process_frame",
                         frame_pairs(got[i], one))
            assert_exact(f"{view} {name} group frame {i} vs the CPU port",
                         frame_pairs(got[i], cpu.process_frame(ev)))
            assert_exact(f"{view} {name} packed group frame {i} vs process_frame", [
                (packed[i].frame_bgr, eng.process_frame(
                    ev, display_only=True, display_packed=True).frame_bgr)])
        eng.set_frame_filter("none")
        log(f"  {view} ({name}): process_frames of {len(fr)} frames, each bit-equal to "
            f"process_frame on the card and to the CPU port (display-packed too); inliers "
            f"{[int(o.num_inliers) for o in got]}")
    log(f"  launches {launches}: one kernel 1 and one tail a group, one kernel F a filtered "
        f"group {card}")
    return launches, groups


def phase4c_mesh(card, errs, engines, frames, eng_e, esl_frames):
    """Phase 4c: scale-out on a virtual mesh of the one card (``cuda:0``
    listed data x event times: the sharded programs, their copies and
    collectives, with the real kernels 1, 2 and 3 on every device of the
    mesh).  ``parallel.make_sharded_pipeline`` of the 12 demonstrator
    frames at each of ``MESH_SHAPES`` in both views, of the 3 ESL frames at
    (1, 2), of the 12 frames with ``first_per_xy`` at (2, 2); then
    ``process_frames_sharded`` of the 12 frames and of 7 (uneven blocks) at
    data 4 in both views.  One launch of kernel 1's group entry a mesh
    device and one tail group call a data row; every element bit-equal to
    ``process_frame`` on the card and to the CPU port.  Returns the
    launches, counted from 0 just before the runs and read just after."""
    import torch
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.parallel import make_mesh, make_sharded_pipeline, shard_batches
    from xmaps_tpu_torch.parallel.sharding import split_frames

    t_phase = time.perf_counter()
    log("phase 4c scale-out on a virtual mesh of the one card:")
    runs = [(view, eng, frames, "none", shape)
            for view, eng in engines.items() for shape in MESH_SHAPES]
    runs += [("esl_projector", eng_e, esl_frames, "none", (1, 2)),
             ("projector", engines["projector"], frames, "first_per_xy", (2, 2))]
    engine_runs = [(view, eng, frames[:n]) for view, eng in engines.items()
                   for n in (len(frames), 7)]
    placed = []
    for _, eng, fr, _, (d, e) in runs:
        mesh = make_mesh(["cuda:0"] * (d * e), data=d, event=e)
        placed.append((mesh, shard_batches([eng.make_batch(ev) for ev in fr], mesh, eng.cfg)))
    mesh4 = make_mesh(["cuda:0"] * 4)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    outs = []
    for (_, eng, _, name, _), (mesh, batch) in zip(runs, placed):
        eng.set_frame_filter(name)
        outs.append(make_sharded_pipeline(eng.cfg, eng.tables, mesh, eng.plan)(batch))
        eng.set_frame_filter("none")
    engine_outs = [eng.process_frames_sharded(fr, mesh4) for _, eng, fr in engine_runs]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    run_s = time.perf_counter() - t_phase

    def tail(eng):
        return "colorize_camera_group" if eng.cfg.camera_perspective else "tail_projector_group"

    want = {k: 0 for k in launches}
    for _, eng, _, name, (d, e) in runs:
        want["event_disparity_scatter_group"] += d * e
        want[tail(eng)] += d
        # a filtered row: its frames gathered on the leader, one kernel F
        want["frame_dedup_filter_group"] += d * (name != "none")
    for _, eng, _ in engine_runs:
        want["event_disparity_scatter_group"] += 4
        want[tail(eng)] += 4
    if launches != want:
        raise AssertionError(f"phase 4c launches {launches} != {want}")
    cpus = {id(eng): eng.to("cpu") for eng in (*engines.values(), eng_e)}
    refs = {}

    def expected(eng, name, i, ev):
        """(process_frame on the card, the CPU port's) of frame i."""
        key = (id(eng), name, i)
        if key not in refs:
            eng.set_frame_filter(name)
            cpus[id(eng)].set_frame_filter(name)
            refs[key] = (eng.process_frame(ev), cpus[id(eng)].process_frame(ev))
            eng.set_frame_filter("none")
            cpus[id(eng)].set_frame_filter("none")
        return refs[key]

    err = 0.0
    for (view, eng, fr, name, (d, e)), out in zip(runs, outs):
        for i, ev in enumerate(fr):
            got = type(out)(*(a[i] for a in out))
            card_ref, cpu_ref = expected(eng, name, i, ev)
            err = max(err, assert_exact(f"{view} {name} mesh {d}x{e} frame {i} vs process_frame",
                                        frame_pairs(got, card_ref)))
            err = max(err, assert_exact(f"{view} {name} mesh {d}x{e} frame {i} vs the CPU port",
                                        frame_pairs(got, cpu_ref)))
        log(f"  {view} ({name}) mesh {d}x{e}: {len(fr)} frames bit-equal to process_frame and "
            f"the CPU port; inliers {[int(v) for v in out.num_inliers]}")
    for (view, eng, fr), got in zip(engine_runs, engine_outs):
        if len(got) != len(fr):
            raise AssertionError(f"process_frames_sharded: {len(got)} results for {len(fr)}")
        for i, (g, ev) in enumerate(zip(got, fr)):
            card_ref, cpu_ref = expected(eng, "none", i, ev)
            err = max(err, assert_exact(f"{view} process_frames_sharded frame {i} of {len(fr)}",
                                        frame_pairs(g, card_ref) + frame_pairs(g, cpu_ref)))
        blocks = [sl.stop - sl.start for sl in split_frames(len(fr), 4)]
        log(f"  {view}: process_frames_sharded of {len(fr)} frames at data 4 (blocks {blocks}): "
            f"bit-equal to process_frame and the CPU port")
    for k in ("event_disparity_scatter_group", "tail_projector_group", "colorize_camera_group"):
        errs[k] = max(errs.get(k, 0.0), err)
    log(f"  launches {launches}: one kernel 1 group launch a mesh device, one tail group call "
        f"a data row, one kernel F group launch a filtered data row; max_abs_err {err}; runs "
        f"{run_s:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s {card}")
    return launches


def time_group(card, engines, frames, kernels_ms, shapes, groups):
    """Phase 6, the group: device and wall ms a frame of ``process_frames``
    over the 12 frames against the per-frame loop (``process_frame`` each),
    display-packed, in turns (group, loop, loop, group; device: profiler,
    4 calls of 12 frames a turn; wall: host clock + synchronize, median of
    10 calls a turn); then each group entry against its plain version
    (kernels_ms) with the L2 cache flushed before each call, as its HBM
    bound assumes (back to back, the group's maps and outputs stay in the
    50 MB L2: that time is logged beside), and the shapes of the group
    entries' bounds."""
    import torch
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter_staged_group,
        event_disparity_scatter_staged_group_plain,
    )
    from xmaps_tpu_torch.ops.cuda_tail import (
        colorize_camera_group,
        colorize_camera_group_plain,
        tail_projector_group,
        tail_projector_group_plain,
    )

    disp = dict(display_only=True, display_packed=True)
    f = len(frames)
    for view, eng in engines.items():
        calls = {"group": lambda: eng.process_frames(frames, **disp),
                 "loop": lambda: [eng.process_frame(ev, **disp) for ev in frames]}
        for fn in calls.values():
            fn()
        res = {k: [] for k in calls}
        for k in ("group", "loop", "loop", "group"):
            dev, by_name = profile_calls(calls[k], 4)
            wall = []
            for _ in range(10):
                t0 = time.perf_counter()
                calls[k]()
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            res[k].append((dev / f, statistics.median(wall) / f, by_name))
        (g1, g2), (l1, l2) = res["group"], res["loop"]
        top = {k.replace("(anonymous namespace)::", "")[:48]: round(v * 1e3 / f, 3)
               for k, v in sorted(g1[2].items(), key=lambda kv: -kv[1])[:5]}
        log(f"  {view} group of {f}: device {(g1[0] + g2[0]) / 2:.5f} ms/frame (turns "
            f"{g1[0]:.5f}, {g2[0]:.5f}) vs loop {(l1[0] + l2[0]) / 2:.5f} ({l1[0]:.5f}, "
            f"{l2[0]:.5f}); wall {(g1[1] + g2[1]) / 2:.5f} ms/frame ({g1[1]:.5f}, {g2[1]:.5f}) "
            f"vs loop {(l1[1] + l2[1]) / 2:.5f} ({l1[1]:.5f}, {l2[1]:.5f}) {card}")
        log(f"      the group's device events, us/frame: {top}")

    layout = engines["projector"].compact_layout
    packed_disp = dict(emit_aux=False, packed_bgr=True)
    eng_p, eng_c = engines["projector"], engines["camera"]
    (staged_p, ev_p), (staged_c, ev_c) = groups["projector"], groups["camera"]
    kw_p = view_kwargs(eng_p)[0]
    pairs = {
        "event_disparity_scatter_group": (
            lambda: event_disparity_scatter_staged_group(staged_p, layout, eng_p.tables, **kw_p),
            lambda: event_disparity_scatter_staged_group_plain(staged_p, layout, eng_p.tables,
                                                               **kw_p)),
        "tail_projector_group": (
            lambda: tail_projector_group(ev_p.packed_map, eng_p.tables, eng_p.plan,
                                         **packed_disp),
            lambda: tail_projector_group_plain(ev_p.packed_map, eng_p.tables, eng_p.plan,
                                               **packed_disp)),
        "colorize_camera_group": (
            lambda: colorize_camera_group(ev_c.packed_map, eng_c.tables, eng_c.plan,
                                          **packed_disp),
            lambda: colorize_camera_group_plain(ev_c.packed_map, eng_c.tables, eng_c.plan,
                                                **packed_disp)),
    }
    warm_ms = {}
    for k, (kernel_fn, plain_fn) in pairs.items():
        kernels_ms[k] = time_pair(kernel_fn, plain_fn, cold=True, plain_iters=COLD_PLAIN_ITERS)
        warm_ms[k] = device_ms(kernel_fn)[0]
    t = eng_p.tables
    lut_b, xmap_b = t.cam_map_packed.numel() * 4, t.x_map.numel() * 2
    shapes["event_disparity_scatter_group"] = (
        staged_p.host_counts, lut_b, xmap_b, ev_p.packed_map[0].numel())
    shapes["tail_projector_group"] = (f, ev_p.packed_map[0].numel(), t.proj_mapx_i16.numel(),
                                      projector_disparities(ev_p.packed_map, t, eng_p.plan))
    shapes["colorize_camera_group"] = (
        ev_c.packed_map[0].numel(), [distinct_disparities(m) for m in ev_c.packed_map])
    for k in ("event_disparity_scatter_group", "tail_projector_group", "colorize_camera_group"):
        km, pm = kernels_ms[k]
        bound = kernel_bytes(k, shapes) / HBM_BYTES_PER_S * 1e3
        log(f"  kernel {k} ({f} frames a call): {km['ms']:.5f} ms device, L2 flushed before "
            f"each call (turns {km['turns'][0]:.5f}, {km['turns'][1]:.5f}), "
            f"{km['ms'] / f:.6f} ms/frame; back to back {warm_ms[k]:.5f} ms; plain "
            f"{pm['ms']:.5f} ms (flushed); bound {bound:.6f} ms (bytes), share "
            f"{bound / km['ms']:.4f} {card}")


def time_kernel2_esl(card, eng, frames):
    """Phase 6: kernel 2 at the ESL Table-2 rig (crop and projector of
    ``eng``), beside the demonstrator's rows: one frame and the group of
    ``frames``, each with the L2 cache flushed before each call, display-
    packed, against its plain version in turns, with its bound (bytes,
    ``kernel_bytes``), share and the dilate / remap split (device ms a
    call by kernel name)."""
    from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter_staged_group
    from xmaps_tpu_torch.ops.cuda_tail import (
        tail_projector,
        tail_projector_group,
        tail_projector_group_plain,
        tail_projector_plain,
    )

    t, plan = eng.tables, eng.plan
    packed = event_disparity_scatter_staged_group(
        eng.stage_group(frames), eng.compact_layout, t, **view_kwargs(eng)[0]).packed_map
    one = packed[0].clone()
    disp = dict(emit_aux=False, packed_bgr=True)
    crop_px, proj_px = one.numel(), t.proj_mapx_i16.numel()
    rows = {
        "tail_projector": (
            lambda: tail_projector(one, t, plan, **disp),
            lambda: tail_projector_plain(one, t, plan, **disp),
            (crop_px, proj_px, projector_disparities(one, t, plan), False)),
        "tail_projector_group": (
            lambda: tail_projector_group(packed, t, plan, **disp),
            lambda: tail_projector_group_plain(packed, t, plan, **disp),
            (len(frames), crop_px, proj_px, projector_disparities(packed, t, plan))),
    }
    for k, (kernel_fn, plain_fn, shape) in rows.items():
        km, pm = time_pair(kernel_fn, plain_fn, cold=True, plain_iters=COLD_PLAIN_ITERS)
        bound = kernel_bytes(k, {k: shape}) / HBM_BYTES_PER_S * 1e3
        if bound > MAX_SHARE * km["ms"]:
            raise AssertionError(f"ESL {k}: share {bound / km['ms']:.4f} over {MAX_SHARE}")
        log(f"  kernel {k} at the ESL rig (crop {plan.H}x{plan.W}, projector "
            f"{tuple(t.proj_mapx_i16.shape)}, {shape[0] if k.endswith('group') else 1} "
            f"frame(s) a call, L2 flushed before each call): {km['ms']:.5f} ms device (turns "
            f"{km['turns'][0]:.5f}, {km['turns'][1]:.5f}; ms a call by kernel {km['top']}), plain "
            f"{pm['ms']:.5f} ms; bound {bound:.6f} ms (bytes), share {bound / km['ms']:.4f} "
            f"{card}")


def time_kernel1_esl(card, eng, frames):
    """Phase 6: kernel 1 at the ESL Table-2 rig (the 5760 x 1080 X-map and
    the crop of ``eng``), beside the demonstrator's rows: the staged
    one-frame entry on the first frame and the staged group entry on
    ``frames``, each checked bit-equal to its plain version, then timed
    against it in turns with the L2 cache flushed before each call, with
    its bound (bytes, ``kernel_bytes``) and share."""
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter_staged,
        event_disparity_scatter_staged_group,
        event_disparity_scatter_staged_group_plain,
        event_disparity_scatter_staged_plain,
    )

    t, layout = eng.tables, eng.compact_layout
    kw = view_kwargs(eng)[0]
    group = eng.stage_group(frames)
    word, n = group.word[0], group.host_counts[0]
    tables_b = (t.cam_map_packed.numel() * 4, t.x_map.numel() * 2)
    out_px = kw["out_shape"][0] * kw["out_shape"][1]
    rows = {
        "event_disparity_scatter_staged": (
            lambda: event_disparity_scatter_staged(word, n, layout, t, **kw),
            lambda: event_disparity_scatter_staged_plain(word, n, layout, t, **kw),
            (n, *tables_b, out_px)),
        "event_disparity_scatter_group": (
            lambda: event_disparity_scatter_staged_group(group, layout, t, **kw),
            lambda: event_disparity_scatter_staged_group_plain(group, layout, t, **kw),
            (group.host_counts, *tables_b, out_px)),
    }
    for k, (kernel_fn, plain_fn, shape) in rows.items():
        assert_exact(f"ESL {k}", list(zip(kernel_fn()[:2], plain_fn()[:2])))
        km, pm = time_pair(kernel_fn, plain_fn, cold=True, plain_iters=COLD_PLAIN_ITERS)
        bound = kernel_bytes(k, {k: shape}) / HBM_BYTES_PER_S * 1e3
        if bound > MAX_SHARE * km["ms"]:
            raise AssertionError(f"ESL {k}: share {bound / km['ms']:.4f} over {MAX_SHARE}")
        f = len(shape[0]) if k.endswith("group") else 1
        log(f"  kernel {k} at the ESL rig (X-map {tuple(t.x_map.shape)}, map "
            f"{kw['out_shape']}, {f} frame(s) a call, bit-equal to the plain version, L2 "
            f"flushed before each call): {km['ms']:.5f} ms device (turns {km['turns'][0]:.5f}, "
            f"{km['turns'][1]:.5f}), {km['ms'] / f * 1e3:.3f} us a frame; plain {pm['ms']:.5f} "
            f"ms; bound {bound:.6f} ms (bytes), share {bound / km['ms']:.4f} {card}")


def filters_out_of_camera(engines, frames):
    """Phase 5b: each dedup filter on frames with events outside the camera
    (a larger sensor than the configured camera): no device-side assert,
    and every frame bit-equal to the CPU port."""
    import torch
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES
    from xmaps_tpu_torch.utils.synthetic import with_events_outside_camera

    rng = np.random.default_rng(21)
    for view, eng in engines.items():
        cpu = eng.to("cpu")
        cam_w, cam_h = eng.cfg.camera_width, eng.cfg.camera_height
        # within the capacity, so the injected events reach the filters
        fr = [with_events_outside_camera(ev[: eng.cfg.event_capacity - 2000], rng, cam_w, cam_h,
                                         n=200)
              for ev in frames]
        for name in FILTER_NAMES[1:]:
            eng.set_frame_filter(name)
            cpu.set_frame_filter(name)
            outs = [eng.process_frame(ev) for ev in fr]
            torch.cuda.synchronize()
            for i, (ev, got) in enumerate(zip(fr, outs)):
                assert_exact(f"{name} {view} out-of-camera frame {i} cuda vs cpu",
                             frame_pairs(got, cpu.process_frame(ev)))
            eng.set_frame_filter("none")
        log(f"  {view}: the four dedup filters on {len(fr)} frames with 400 events outside "
            f"the {cam_w}x{cam_h} camera each: no device assert, bit-equal to the CPU port")


def time_filters(card, what, eng, frames, names, kernels_ms=None, shapes=None):
    """Phase 6, the filters: per dedup filter of ``names``, wall ms a
    frame (median of 60), device ms a frame and kernel F's share of it
    (profiler, 48 frames); with ``kernels_ms``, the plain version's device
    ms on frame 0 on the card (profiler, 20 calls).  Where ``shapes`` is
    given, kernel F against its plain version in turns (``time_pair``) on
    frame 0 with first_per_yt (the E key's first filter) and its group
    entry on the stacked frames with first_per_xy (phase 4b's filtered
    group), filling ``kernels_ms`` and ``shapes`` (the bound's inputs).
    The kernel does not depend on the view: one view's engine times it."""
    import torch
    from xmaps_tpu_torch.ops.event_batch import EventBatch
    from xmaps_tpu_torch.ops.filters import (
        apply_frame_filter_group,
        apply_frame_filter_group_plain,
        apply_frame_filter_plain,
        lut_rectified_x,
    )

    cfg, lut = eng.cfg, eng.tables.cam_map_packed
    kw = dict(camera_width=cfg.camera_width, camera_height=cfg.camera_height,
              rect_width=cfg.rect_width)
    batch = eng.make_batch(frames[0])

    def lanes(b, name):
        """(lanes, positive lanes, LUT bytes read or 0, mean filter) a frame."""
        pos = b.valid & (b.p == 1)
        return [(b.capacity, int(p.sum()), lut.numel() * 4 if name == "first_per_yt" else 0,
                 name == "mean_first_last_per_xy") for p in pos.reshape(-1, b.capacity)]

    def bound_ms(key, b, name):
        return kernel_bytes(key, {key: lanes(b, name)}) / HBM_BYTES_PER_S * 1e3

    for name in names:
        eng.set_frame_filter(name)
        w, p90, dev, by_name = time_frames(eng, frames)
        kf = sum(v for k, v in by_name.items() if "frame_dedup_filter" in k)
        if not kf:
            raise AssertionError(f"{what} {name}: no kernel F event in the frames' profile")
        line = (f"  {what} {name}: {w:.4f} ms/frame wall median (p90 {p90:.4f}), {dev:.4f} "
                f"ms/frame device, of it kernel F {kf * 1e3:.3f} us")
        if kernels_ms is None:
            log(f"{line} {card}")
            eng.set_frame_filter("none")
            continue
        xr = lut_rectified_x(batch.x, batch.y, lut) if name == "first_per_yt" else None

        def plain():
            return apply_frame_filter_plain(batch, xr, name=name, **kw)

        bound = bound_ms("frame_dedup_filter", batch, name)
        if shapes is not None and name == "first_per_yt":
            km, pm = time_pair(lambda: filter_batch(eng, batch, name), plain)
            kernels_ms["frame_dedup_filter"] = (km, pm)
            shapes["frame_dedup_filter"] = lanes(batch, name)
            line += (f"; frame 0 in turns: kernel F {km['ms'] * 1e3:.3f} us (turns "
                     f"{km['turns'][0] * 1e3:.3f}, {km['turns'][1] * 1e3:.3f})")
            plain_ms, top = pm["ms"], pm["top"]
        else:
            plain_ms, top = profile_calls(plain, 20)
            top = sorted(top.items(), key=lambda kv: -kv[1])[:3]
        log(f"{line}; bound {bound * 1e3:.4f} us (bytes, frame 0), share {bound / kf:.4f}; "
            f"plain version on frame 0 {plain_ms * 1e3:.3f} us (top us: "
            f"{[(k[:40], round(v * 1e3, 2)) for k, v in top]}) {card}")
        if shapes is not None and name == "first_per_xy":
            group = EventBatch.stack_structured(frames, cfg.event_capacity, device="cuda")
            km, pm = time_pair(
                lambda: apply_frame_filter_group(group, None, name=name, cam_lut=lut, **kw),
                lambda: apply_frame_filter_group_plain(group, None, name=name, **kw))
            kernels_ms["frame_dedup_filter_group"] = (km, pm)
            shapes["frame_dedup_filter_group"] = lanes(group, name)
            bound = kernel_bytes("frame_dedup_filter_group", shapes) / HBM_BYTES_PER_S * 1e3
            log(f"  {what} {name}, kernel F's group entry on {len(frames)} frames: "
                f"{km['ms'] * 1e3:.3f} us device (turns {km['turns'][0] * 1e3:.3f}, "
                f"{km['turns'][1] * 1e3:.3f}), {km['ms'] / len(frames) * 1e3:.3f} us a frame; "
                f"bound {bound * 1e3:.4f} us (bytes), share {bound / km['ms']:.4f}; plain "
                f"version {pm['ms'] * 1e3:.3f} us {card}")
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


def device_events(fn, iters):
    """The device-side events (kernels, memsets, copies) of ``iters`` calls
    of ``fn`` under torch.profiler, as (name, start us, duration us) in
    time order: ``utils.profiling.device_events`` (the calls between two
    marker kernels, with ``PROFILE_PAD_S`` seconds of untimed calls on each
    side, retaken on a lost event; a ``RuntimeError`` after 3 sessions)."""
    from xmaps_tpu_torch.utils.profiling import device_events as events

    return events(fn, iters, pad_s=PROFILE_PAD_S)


def profile_calls(fn, iters, counts=None):
    """Device ms per call of ``fn`` over ``iters`` calls under
    torch.profiler: the summed duration of every device-side event the
    calls launched (kernels, memsets, copies), in total and by event name;
    ``counts``, where given, gets the device events a call by name.
    Returns (None, {}) if the profiler recorded no device event."""
    by_name: dict = {}
    for name, _, us in device_events(fn, iters):
        by_name[name] = by_name.get(name, 0.0) + us / 1e3 / iters
        if counts is not None:
            counts[name] = counts.get(name, 0.0) + 1 / iters
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


#: the L2 flush's buffer and its device events' names, made once
_FLUSH: dict = {}


def l2_flush():
    """(buffer, names): ``L2_FLUSH_BYTES`` to ``bitwise_not_`` and the
    names of the device events that flush runs (profiled once)."""
    import torch

    if not _FLUSH:
        buf = torch.zeros(L2_FLUSH_BYTES // 8, dtype=torch.int64, device="cuda")
        _, names = profile_calls(buf.bitwise_not_, 4)
        if not names:
            raise AssertionError("the profiler recorded no device event of the L2 flush")
        _FLUSH.update(buf=buf, names=set(names))
    return _FLUSH["buf"], _FLUSH["names"]


def cold_device_ms(fn, iters=50, checked=False):
    """``device_ms`` of ``fn`` with the L2 cache flushed before each call:
    each call follows a ``bitwise_not_`` of ``L2_FLUSH_BYTES`` (5x the
    H100's 50 MB L2, so the call reads its inputs from HBM and evicts the
    flush's dirty lines as it writes), whose device events are left out of
    the sum (the profiler's time only; the CUDA-event time includes them).
    Raises if ``fn`` itself runs a kernel of the flush's name (``checked``:
    ``fn`` was checked so before)."""
    buf, flush = l2_flush()
    if not checked:
        _, own = profile_calls(fn, 4)
        if flush & set(own):
            raise AssertionError(f"the L2 flush's device events {sorted(flush)} are not "
                                 f"apart from the call's {sorted(own)}")

    def call():
        buf.bitwise_not_()
        fn()

    _, source, ev, names = device_ms(call, iters)
    if source != "profiler":
        raise AssertionError("the profiler recorded no device event: no cold time")
    names = {k: v for k, v in names.items() if k not in flush}
    return sum(names.values()), "profiler, L2 flushed", ev, names


def time_pair(kernel_fn, plain_fn, cold=False, plain_iters=50):
    """Kernel vs plain in turns (plain, kernel, kernel, plain) after a
    warm-up of each; each entry is a mean of the two turns.  ``cold``:
    each call finds the L2 cache flushed (``cold_device_ms``; each function
    checked apart from the flush once), else the calls run back to back.
    ``plain_iters``: the plain version's calls a turn (the kernel's: 50)."""
    kernel_fn()
    plain_fn()
    timer = cold_device_ms if cold else device_ms
    again = functools.partial(cold_device_ms, checked=True) if cold else device_ms
    p1 = timer(plain_fn, plain_iters)
    k1 = timer(kernel_fn)
    k2 = again(kernel_fn)
    p2 = again(plain_fn, plain_iters)

    def mean(a, b):
        top = sorted(((k.replace("(anonymous namespace)::", ""), v) for k, v in b[3].items()),
                     key=lambda kv: -kv[1])[:3]
        return dict(ms=(a[0] + b[0]) / 2, source=a[1], issue_ms=(a[2] + b[2]) / 2,
                    turns=(a[0], b[0]), top=[(k[:40], round(v, 6)) for k, v in top])

    return mean(k1, k2), mean(p1, p2)


def is_fill(name) -> bool:
    """Whether a device event is torch's fill kernel (``torch.zeros``,
    ``full``, ``zero_``, a Python scalar wrapped on the card)."""
    return "FillFunctor" in name


def fills_a_call(fn):
    """The fill kernels a call of ``fn`` runs on the card, by name, from
    12 profiled calls."""
    counts: dict = {}
    profile_calls(fn, 12, counts)
    return {k.replace("at::native::", "")[:90]: round(v, 3) for k, v in counts.items()
            if is_fill(k)}


def time_kernel1_entries(card, eng, ev, batch, t_bin, kw, shapes):
    """Phase 6: kernel 1's staged entry against its array entry, then its
    ring entry against its staged entry, each pair in turns, on the
    demonstrator's projector frame 0 (the ring holds it as 4 arrival
    packets), with no fill kernel beside any entry (each zeroes the map
    inside its launch); the bound of the staged and ring entries (4 B an
    event read in place of 13)."""
    from xmaps_tpu_torch.io.prefetch import HostStagingPool
    from xmaps_tpu_torch.ops.cuda_events import (
        event_disparity_scatter,
        event_disparity_scatter_ring,
        event_disparity_scatter_staged,
    )

    staged = HostStagingPool(eng.cfg.event_capacity, device="cuda",
                             layout=eng.compact_layout).stage_compact(ev)
    _, ((pkts, meta, t_bounds),) = ring_of_frames(eng, [ev])
    rows = tuple(p.xy for p in pkts)
    calls = {
        "array": lambda: event_disparity_scatter(batch, t_bin, eng.tables, **kw),
        "staged": lambda: event_disparity_scatter_staged(
            staged.word, staged.count, eng.compact_layout, eng.tables, **kw),
        "ring": lambda: event_disparity_scatter_ring(
            rows, meta, staged.count, t_bounds, eng.ring_layout, eng.tables,
            t_px_scale=eng.cfg.t_px_scale, **kw),
    }
    for entry, fn in calls.items():
        fills = fills_a_call(fn)
        if fills:
            raise AssertionError(f"kernel 1's {entry} entry runs a fill kernel: {fills}")
    assert_exact("kernel 1's ring entry vs its staged entry", [
        (calls["ring"]().packed_map, calls["staged"]().packed_map)])
    st, arr = time_pair(calls["staged"], calls["array"])
    rg, st2 = time_pair(calls["ring"], calls["staged"])
    _, _, lut_b, xmap_b, out_px = shapes["event_disparity_scatter"]
    n = staged.count
    bound = kernel_bytes("event_disparity_scatter_staged", {
        "event_disparity_scatter_staged": (n, lut_b, xmap_b, out_px)}) / HBM_BYTES_PER_S * 1e3
    log(f"  kernel 1 staged entry (count {n}): {st['ms']:.5f} ms (turns {st['turns'][0]:.5f}, "
        f"{st['turns'][1]:.5f}) vs the array entry {arr['ms']:.5f} ms in the same turns; bound "
        f"{bound:.6f} ms (bytes, 4 B an event), share {bound / st['ms']:.4f} {card}")
    log(f"  kernel 1 ring entry ({len(pkts)} packets, count {n}): {rg['ms']:.5f} ms (turns "
        f"{rg['turns'][0]:.5f}, {rg['turns'][1]:.5f}) vs the staged entry {st2['ms']:.5f} ms in "
        f"the same turns ({rg['ms'] / st2['ms']:.3f}x); bound {bound:.6f} ms (bytes, 4 B an "
        f"event), share {bound / rg['ms']:.4f} {card}")


def time_offset_entry(card, eng, batch, t_bin, kw):
    """Phase 6: kernel 1's array entry with the (1, 2) mesh's second
    shard's lane offset (capacity / 2) against offset 0, in turns, on the
    demonstrator's projector frame 0 (the same lanes, only the keys'
    priorities differ)."""
    from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter

    off = eng.cfg.event_capacity // 2
    on, zero = time_pair(
        lambda: event_disparity_scatter(batch, t_bin, eng.tables, index_offset=off, **kw),
        lambda: event_disparity_scatter(batch, t_bin, eng.tables, **kw))
    log(f"  kernel 1 array entry at index_offset {off}: {on['ms']:.5f} ms (turns "
        f"{on['turns'][0]:.5f}, {on['turns'][1]:.5f}) vs offset 0 {zero['ms']:.5f} ms "
        f"({zero['turns'][0]:.5f}, {zero['turns'][1]:.5f}) in the same turns, "
        f"{on['ms'] / zero['ms']:.3f}x {card}")


def time_mesh(card):
    """Phase 6: the mesh timings, from one run of ``apps.bench_scaling
    --virtual 4`` (the one card listed 4 times), whose JSON line is printed:
    each shape's wall and device ms a frame, ``make_sharded_pipeline`` on
    placed batches and ``process_frames_sharded`` with its staging."""
    from xmaps_tpu_torch.apps import bench_scaling

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_scaling.main(["--virtual", "4"])
    line = out.getvalue().strip().splitlines()[-1]
    doc = json.loads(line)
    rows = [("make_sharded_pipeline", doc["results"]),
            ("process_frames_sharded", doc["group_live_path"]["results"])]
    if not (rc == 0 and doc["device"] == "cuda" and doc["virtual"] and all(
            v["device_step_ms"] for _, res in rows for v in res.values())):
        raise AssertionError(f"apps.bench_scaling: {line}")
    for what, res in rows:
        for shape, v in res.items():
            log(f"  {what} {shape} ({v['frames_per_step']} frames, {doc['frames_per_row']} a "
                f"row): device {v['device_frame_ms']:.5f} ms/frame (eff "
                f"{v['device_weak_scaling_eff']:.3f}), wall {v['frame_ms']:.5f} ms/frame (eff "
                f"{v['weak_scaling_eff']:.3f}) {card}")
            log(f"      top device events, us a step: "
                f"{ {k: round(us, 2) for k, us in v['device_top_us'].items()} }")
    log(f"  apps.bench_scaling --virtual 4: its JSON line {card}:")
    print(line, flush=True)


def time_ring_vs_staged(card, eng, frames):
    """Phase 6: the engine's dispatch of a frame from the trigger on, in
    turns: the ring (``PacketRing.frame``: ``frame_meta`` and the time
    bounds, then ``process_ring`` on packets already on the card) against segmented staging
    (``stage_compact`` and ``process_staged``); wall ms a frame (host clock
    + synchronize, median of 60) and device ms a frame (profiler, 48
    frames), on the demonstrator frames."""
    import torch
    from xmaps_tpu_torch.io.prefetch import HostStagingPool

    cap = eng.cfg.event_capacity
    ring, held = ring_of_frames(eng, frames)
    pool = HostStagingPool(cap, device="cuda", layout=eng.compact_layout)
    bases = np.cumsum([0] + [len(ev) for ev in frames])

    def ring_dispatch(i):
        return eng.process_ring(*ring.frame(int(bases[i]), frames[i], cap))

    def staged_dispatch(i):
        return eng.process_staged(pool.stage_compact(frames[i]))

    for i in range(len(frames)):
        assert_exact(f"process_ring vs process_staged, frame {i}", [
            (ring_dispatch(i).frame_bgr, staged_dispatch(i).frame_bgr)])
    out = {}
    for name, fn in (("ring", ring_dispatch), ("staged", staged_dispatch),
                     ("staged", staged_dispatch), ("ring", ring_dispatch)):
        wall = []
        for j in range(60):
            t0 = time.perf_counter()
            fn(j % len(frames))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        it = itertools.cycle(range(len(frames)))
        dev, _ = profile_calls(lambda: fn(next(it)), 48)
        out.setdefault(name, []).append((statistics.median(wall), dev))
    view = "camera" if eng.cfg.camera_perspective else "projector"
    (rw, rd), (sw, sd) = ([statistics.mean(v) for v in zip(*out[k])] for k in ("ring", "staged"))
    log(f"  {view} dispatch from the trigger, in turns: ring (frame_meta + bounds + "
        f"process_ring) {rw:.4f} ms wall, {rd:.4f} ms device a frame (turns "
        f"{[round(w, 4) for w, _ in out['ring']]}); segmented (stage_compact + process_staged) "
        f"{sw:.4f} ms wall, {sd:.4f} ms device (turns {[round(w, 4) for w, _ in out['staged']]})"
        f"; {len(frames)} frames, {ring.packets_staged} packets {card}")
    # the host alone: the engine call without a synchronize, on a batch
    # already staged (segmented) or packets already on the card (ring)
    staged = [pool.stage_compact(ev) for ev in frames[:2]]
    calls = (("process_ring", lambda i: eng.process_ring(*held[i % len(held)])),
             ("process_staged", lambda i: eng.process_staged(staged[i % 2])))
    host = {}
    for name, fn in calls + calls[::-1]:
        ts = []
        for i in range(200):
            t0 = time.perf_counter()
            fn(i)
            ts.append((time.perf_counter() - t0) * 1e3)
            if i % 20 == 19:
                torch.cuda.synchronize()
        host.setdefault(name, []).append(statistics.median(ts))
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for i in range(200):
        calls[0][1](i)
    prof.disable()
    torch.cuda.synchronize()
    top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:6]
    log(f"  {view} host ms a call, no synchronize, median of 200 in turns: "
        + ", ".join(f"{k} {statistics.mean(v):.4f} (turns {[round(x, 4) for x in v]})"
                    for k, v in host.items())
        + "; process_ring's top host functions, us a call (cProfile, tottime): "
        + ", ".join(f"{fn[2][:40]} {st[2] / 200 * 1e6:.1f}" for fn, st in top))


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


def sharded_eval(eng, cams_raw, seq, out_dir):
    """Phase 7: ``apps.eval_xmaps.run_sharded`` (the app's ``-devices N``
    loop) on a virtual mesh of 2 (``cuda:0`` twice) over the scans: each
    depth ``.npy`` byte-equal to the one ``-devices 1`` wrote in ``seq``;
    one launch of kernel 1's and of kernel 3's group entry a scan (each
    data row holds one).  Returns the launches, counted from 0 just before
    and read just after."""
    import torch
    from xmaps_tpu_torch.apps import eval_xmaps
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.parallel import make_mesh

    out_dir.mkdir()
    scans = [(i, eval_xmaps.scan_image_to_events(c)) for i, c in enumerate(cams_raw)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        saved = eval_xmaps.run_sharded(eng, scans, make_mesh(["cuda:0"] * 2), str(out_dir))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    groups = -(-len(scans) // 2)
    want = {k: 0 for k in launches}
    want.update(event_disparity_scatter_group=2 * groups, colorize_camera_group=2 * groups)
    if saved != len(scans) or launches != want:
        raise AssertionError(f"run_sharded saved {saved} of {len(scans)}, launches {launches} "
                             f"!= {want}")
    for i, _ in scans:
        name = f"scans{i:03d}.npy"
        if (out_dir / name).read_bytes() != (seq / "x_maps" / "depth_init" / name).read_bytes():
            raise AssertionError(f"eval_xmaps run_sharded {name} != -devices 1's")
    log(f"  eval_xmaps run_sharded on a virtual mesh of 2: {len(scans)} depth .npy byte-equal "
        f"to -devices 1's; launches {dict((k, v) for k, v in launches.items() if v)}")
    return launches


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
    from xmaps_tpu_torch.models import esl_pipeline
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
    fast = esl_pipeline.build_device_depth_init(maps, calib, proj_rect, p03, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bound = fast.bound
    prep_mb = sum(t.numel() * t.element_size() for t in bound["prep"]) / 1e6
    remap_mb = sum(t.numel() * t.element_size()
                   for t in bound["forward"] + bound["back"]) / 1e6
    box = tuple(bound["prep"][0].shape)
    log(f"  depth-init setup {setup_s:.2f} s: box {box[0]}x{bound['forward'][0].shape[1]} "
        f"(tables {box[0]}x{box[1]}), prep tables {prep_mb:.1f} MB, packed remap indices "
        f"{remap_mb:.1f} MB on the card {card}")
    cams = [esl_pipeline.normalize_scan(c) for c in cams_raw]
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
        want = esl_pipeline.depth_init_dense(cams[i], maps, proj_rect, p03, dev)
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
                    {"esl_disparity_search": n, "remap_gather": 2 * n,
                     "esl_refine": -(-n // esl_pipeline.GROUP_SCANS)})
    esl_peak_mb = (torch.cuda.max_memory_allocated() - mem0) / 1e6
    lm, _ = run_app(eval_mc3d.main, args["cuda"] + ["-device", "cuda"], {})
    lx, _ = run_app(eval_xmaps.main, args["cuda"] + ["-device", "cuda"],
                    {"event_disparity_scatter": n, "colorize_camera": n, "colorize_table": 1})
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
        f"{la['remap_gather']} B + {la['esl_refine']} R for {n} scans (peak "
        f"{esl_peak_mb:.1f} MB above the "
        f"resident tables), eval_mc3d no kernel, eval_xmaps "
        f"{lx['event_disparity_scatter']} x kernel 1 + {lx['colorize_camera']} x kernel 3 "
        f"(+ {lx['colorize_table']} table build) at capacity {ESL_CAM[0] * ESL_CAM[1]}")
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
    table_parity(eng, errs)
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
    for k, v in sharded_eval(eng, cams_raw, seqs["cuda"], root / "sharded").items():
        launches[k] = launches.get(k, 0) + v

    # -- per-scan times, device (profiler) and wall
    plan = esl_pipeline.RefinePlan(calib, maps, 3, *ESL_PROJ)
    disp0, depth0 = fast(cam_dev[0])
    cam_ref = cams[0].copy()
    cam_ref[cam_ref == 0] = 1.0 / cam_ref[0, 0] if cam_ref[0, 0] != 0 else np.inf
    cam_ref = torch.from_numpy(cam_ref).to(dev)
    optim = esl_pipeline.depth_optimization_dense(depth0, cam_ref, plan)
    raw0 = torch.from_numpy(cams_raw[0].astype(np.float32)).to(dev)
    tables = eval_mc3d.build_mc3d_tables(calib, *ESL_PROJ, *ESL_CAM)
    stages = (
        ("ESL depth init (kernels A+B)", lambda: fast(cam_dev[0]), 20),
        ("ESL depth init brute force", lambda: esl_pipeline.depth_init_dense(
            cams[0], maps, proj_rect, p03, dev), 1),
        ("ESL refinement", lambda: esl_pipeline.depth_optimization_dense(depth0, cam_ref, plan), 3),
        ("ESL denoise (bilateral + TV)", lambda: tv_denoise_split_bregman(
            bilateral_filter(optim, d=5, sigma_color=3.0, sigma_space=3.0), mu=0.5), 3),
        ("MC3D (median + search)", lambda: eval_mc3d.mc3d_disparity_dense(
            median_blur_3x3(raw0), tables, *ESL_PROJ), 3),
        ("X-maps (kernels 1+3)", lambda: eng.process_batch_device(batch), 20),
    )
    log(f"  per-scan times {card}:")
    in_stage = {}
    for name, fn, iters in stages:
        w = wall_ms(fn, iters)
        d, by_name = profile_calls(fn, iters)
        if d is None:
            raise AssertionError(f"torch.profiler recorded no device event for {name}")
        top = ", ".join(f"{k[:40]} {v:.4f}" for k, v in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:3])
        log(f"    {name}: {w:.4f} ms/scan wall (median of {iters}), {d:.4f} ms/scan device; "
            f"top: {top}")
        in_stage[name] = by_name
    kernels_ms["esl_disparity_search"] = time_pair(
        lambda: esl_search_box(cam_box, prep, **search),
        lambda: esl_search_box_plain(cam_box, prep, **search),
    )
    # kernel A's bound counts the table elements its search reads on scan 0
    elements = esl_table_elements(cam_box, prep, **search)
    shapes["esl_disparity_search"] = (cam_box.numel(), elements)
    a_ms = sum(v for k, v in in_stage["ESL depth init (kernels A+B)"].items()
               if "esl_search_kernel" in k)
    log(f"  kernel A on scan 0's box ({int((cam_box != 0).sum())} nonzero of {cam_box.numel()} "
        f"px): distinct table elements read {elements}, {4 * sum(elements.values()) / 1e6:.2f} MB"
        f" of tables beside {8 * cam_box.numel() / 1e6:.2f} MB of box in and out; its device "
        f"time inside the depth-init stage {a_ms:.5f} ms a scan, paired "
        f"{kernels_ms['esl_disparity_search'][0]['ms']:.5f} ms {card}")
    if not a_ms:
        raise AssertionError(f"no esl_search_kernel in the depth-init stage: {in_stage}")
    kernels_ms["remap_gather"] = time_pair(
        lambda: (remap_gather(cam_dev[0], *fwd), remap_gather(disp_box, *back)),
        lambda: (remap_gather_plain(cam_dev[0], *fwd), remap_gather_plain(disp_box, *back)),
    )
    shapes["remap_gather"] = [(idx.numel(), int((idx >= 0).sum()), src.numel())
                              for src, (idx,) in ((cam_dev[0], fwd), (disp_box, back))]
    library_ms["remap_gather"] = remap_library_ms(cam_dev[0], fwd, disp_box, back)
    for k in ("esl_disparity_search", "remap_gather"):
        km, pm = kernels_ms[k]
        log(f"  kernel {k}: {km['ms']:.5f} ms device ({km['source']}), plain {pm['ms']:.5f} ms"
            f" per scan (ESL box; remap = forward + back) {card}")
    time_kernel_r(card, errs, kernels_ms, shapes, calib, maps, fast, cam_dev)
    tmp.cleanup()
    log(f"  phase 7 total {time.perf_counter() - t_phase:.1f} s {card}")
    return launches


def time_kernel_r(card, errs, kernels_ms, shapes, calib, maps, fast, cam_dev):
    """Phase 7: kernel R (ESL's refinement at W = 7, the ground truth's
    window) against its plain version on the card, exactly, on one scan
    and on a group of 12 (the phase's scans repeated), each timed in turns
    (device ms a call; the plain version's 13,500 launches a group, 2 and 3
    calls a turn); the one scan's pair is the kernel table's row."""
    import torch
    from xmaps_tpu_torch.models import esl_pipeline
    from xmaps_tpu_torch.ops.esl_refine import esl_refine, esl_refine_plain

    plan = esl_pipeline.RefinePlan(calib, maps, 7, *ESL_PROJ)
    cams = torch.stack([cam_dev[i % len(cam_dev)] for i in range(12)])
    depth = torch.stack([fast(c)[1] for c in cams])
    fill = torch.ones_like(cams[:, 0, 0]) / cams[:, 0, 0]
    imgs = torch.where(cams == 0, fill[:, None, None], cams)
    H, W = depth.shape[1:]
    region = torch.zeros((H, W), dtype=torch.bool, device=depth.device)
    region[plan.window_size:H - plan.window_size, plan.window_size:W - plan.window_size] = True
    calls = {"scan": (depth[:1], imgs[:1]), "group": (depth, imgs)}
    times = {}
    for name, (d, c) in calls.items():
        e = assert_exact(f"esl_refine ({name} of {len(d)}) vs plain on the card",
                         [(esl_refine(d, c, plan), esl_refine_plain(d, c, plan))])
        errs["esl_refine"] = max(errs.get("esl_refine", 0.0), e)
        times[name] = time_pair(lambda: esl_refine(d, c, plan),
                                lambda: esl_refine_plain(d, c, plan),
                                plain_iters=3 if name == "scan" else 2)
        shapes[f"esl_refine_{name}"] = (len(d), H, W, int(((d > 0) & region).sum()), plan.w, 64)
    kernels_ms["esl_refine"] = times["scan"]
    shapes["esl_refine"] = shapes["esl_refine_scan"]
    for name, (km, pm) in times.items():
        shape = {"esl_refine": shapes[f"esl_refine_{name}"]}
        bound, by = kernel_bound_ms("esl_refine", shape)
        bytes_ms = kernel_bytes("esl_refine", shape) / HBM_BYTES_PER_S * 1e3
        if bound > MAX_SHARE * km["ms"]:
            raise AssertionError(f"esl_refine ({name}): share {bound / km['ms']:.4f} over "
                                 f"{MAX_SHARE}")
        log(f"  kernel R esl_refine, {name} of {shape['esl_refine'][0]} at W = 7: "
            f"{km['ms']:.5f} ms device (turns {km['turns'][0]:.5f}, {km['turns'][1]:.5f}), "
            f"plain {pm['ms']:.5f} ms (turns {pm['turns'][0]:.5f}, {pm['turns'][1]:.5f}); "
            f"{shape['esl_refine'][3]} px optimised; bound {bound:.5f} ms ({by}; bytes "
            f"{bytes_ms:.5f} ms), share {bound / km['ms']:.4f}; exact {card}")


@contextlib.contextmanager
def record_pipe(prestage=True):
    """Record what every DepthReprojectionPipe does while the block runs:
    the host clock at each trigger (the trigger finder's frame callback),
    each dispatched frame's segmented events, how it was dispatched ("ring",
    or the staging call of a segmented frame) and its device result, the
    host clock when its result reached the host (frame fetched or inlier
    count read), the pipe, its engine and its stats.  ``prestage`` is set on
    every pipe built inside the block (the pipe's own default is True)."""
    from xmaps_tpu_torch.io.prefetch import HostStagingPool as Pool
    from xmaps_tpu_torch.runtime.pipe import DepthReprojectionPipe as Pipe

    rec = dict(t_trigger=[], events=[], results=[], t_ready=[], engine=None, stats=None,
               how=[], pipe=None)
    orig = {k: getattr(Pipe, k) for k in
            ("__post_init__", "process_ev_frame", "process_ev_frame_indexed",
             "_dispatch_segmented", "_dispatch_ring", "_flush_pending")}
    orig_pool = {k: getattr(Pool, k) for k in ("stage", "stage_compact")}

    def staging(name):
        def stage(self, evs):
            rec["how"].append(name)
            return orig_pool[name](self, evs)
        return stage

    def post_init(self):
        self.prestage = prestage
        orig["__post_init__"](self)
        rec["pipe"] = self

    def process_ev_frame(self, evs):
        rec["t_trigger"].append(time.perf_counter())
        orig["process_ev_frame"](self, evs)

    def process_ev_frame_indexed(self, evs, gstart):
        rec["t_trigger"].append(time.perf_counter())
        orig["process_ev_frame_indexed"](self, evs, gstart)

    def dispatch(self, evs):
        rec["events"].append(evs.copy())
        rec["engine"], rec["stats"] = self.engine, self.stats_printer
        orig["_dispatch_segmented"](self, evs)
        rec["results"].append(self._pending)

    def dispatch_ring(self, evs, gstart):
        done = orig["_dispatch_ring"](self, evs, gstart)
        if done:
            rec["events"].append(evs.copy())
            rec["engine"], rec["stats"] = self.engine, self.stats_printer
            rec["how"].append("ring")
            rec["results"].append(self._pending)
        return done

    def flush(self):
        pending = self._pending is not None
        orig["_flush_pending"](self)
        if pending:
            rec["t_ready"].append(time.perf_counter())

    (Pipe.__post_init__, Pipe.process_ev_frame, Pipe.process_ev_frame_indexed,
     Pipe._dispatch_segmented, Pipe._dispatch_ring, Pipe._flush_pending) = (
        post_init, process_ev_frame, process_ev_frame_indexed, dispatch, dispatch_ring, flush)
    Pool.stage, Pool.stage_compact = staging("stage"), staging("stage_compact")
    try:
        yield rec
    finally:
        for k, fn in orig.items():
            setattr(Pipe, k, fn)
        for k, fn in orig_pool.items():
            setattr(Pool, k, fn)


@contextlib.contextmanager
def profiled_stage_packets():
    """cProfile inside every ``PacketRing.stage_packets`` call made while
    the block runs (and nowhere else).  Yields a dict that holds, once the
    block has ended: ``calls``, ``events`` (staged), ``wall_ms`` (host ms a
    call, profiled) and ``top``: the 10 functions with the most own time
    (name, calls a packet, us a packet), the profiler's own switch left out."""
    from xmaps_tpu_torch.io.prefetch import PacketRing

    prof = cProfile.Profile()
    orig = PacketRing.stage_packets
    out = dict(calls=0, events=0, wall_s=0.0)

    def stage_packets(self, evs):
        out["calls"] += 1
        out["events"] += len(evs)
        t0 = time.perf_counter()
        prof.enable()
        try:
            return orig(self, evs)
        finally:
            prof.disable()
            out["wall_s"] += time.perf_counter() - t0

    PacketRing.stage_packets = stage_packets
    try:
        yield out
    finally:
        PacketRing.stage_packets = orig
    n = max(out["calls"], 1)
    out["wall_ms"] = out["wall_s"] * 1e3 / n
    rows = sorted(((fn, st) for fn, st in pstats.Stats(prof).stats.items()
                   if "_lsprof" not in fn[2]), key=lambda kv: -kv[1][2])[:10]
    out["top"] = [(f"{fn[2][:48]} ({os.path.basename(fn[0])}:{fn[1]})" if fn[0] != "~"
                   else fn[2][:48], st[1] / n, st[2] / n * 1e6) for fn, st in rows]


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


def replay(app, argv, want_tail, expect_frames, keys="", prestage=True):
    """One run of the replay app's ``main`` on the card, its stdout kept
    out of the log, with the launch counts reset just before and read just
    after; ``keys`` are pressed on the processor (its keyboard callback)
    before the replay starts; ``prestage`` is set on the pipe.  Checks that
    the pipe dispatched exactly ``expect_frames`` (the trigger finder's
    frames, from segment_host), the counts and the launches, and with the
    ring that every frame came from it (no ``ring fallback``, no overrun);
    returns (record, counters, replay-loop wall seconds, launches)."""
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
        with record_pipe(prestage) as rec, contextlib.redirect_stdout(out):
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
    ring = rec["pipe"].ring
    if prestage and (ring is None or rec["how"] != ["ring"] * n or ring.overruns
                     or counters.get("ring fallback", 0)):
        raise AssertionError(f"prestaged replay: dispatched {collections.Counter(rec['how'])}, "
                             f"overruns {ring and ring.overruns}, {counters}")
    if not prestage and (ring is not None or "ring" in rec["how"]):
        raise AssertionError("a prestage=False replay used the ring")
    want = {k: 0 for k in launches}
    # the app's engine builds its colorize table once, in either view; a
    # key pressed selects a dedup filter: one kernel F a frame
    want.update({"event_disparity_scatter": n, want_tail: n, "colorize_table": 1,
                 "frame_dedup_filter": n if keys else 0})
    if launches != want:
        raise AssertionError(f"replay launches {launches} != {want}")
    return rec, counters, loop_s[0], launches


def check_replay_frames(what, rec, errs):
    """Every frame the pipe computed on the card equals the CPU port's
    process_staged of the same segmented events, staged as the pipe stages
    a segmented frame (1 word an event; 2 words with a dedup filter), bit
    for bit, however it was dispatched (from the ring, or segmented)."""
    from xmaps_tpu_torch.io.prefetch import HostStagingPool

    cpu = rec["engine"].to("cpu")
    pool = HostStagingPool(cpu.cfg.event_capacity, device="cpu", layout=cpu.compact_layout)
    how = "stage" if cpu.cfg.frame_filter != "none" else "stage_compact"
    if not set(rec["how"]) <= {how, "ring"} or len(rec["how"]) != len(rec["events"]):
        raise AssertionError(f"{what}: the pipe dispatched {set(rec['how'])}, not {how} or ring")
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
    host-to-device copies; device ms by event name; the events that follow
    each host-to-device copy) in a torch.profiler chrome trace."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    events.sort(key=lambda e: e["ts"])
    dev = h2d = 0.0
    by_name: dict = {}
    after = []
    for i, e in enumerate(events):
        dev += e["dur"] / 1e3
        name = e.get("name", "").replace("(anonymous namespace)::", "")
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
        if e["cat"] == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            h2d += e["dur"] / 1e3
            after.append(events[i + 1].get("name", "") if i + 1 < len(events) else "(end)")
    return dev, h2d, by_name, after


def copies_into_kernel1(after) -> int:
    """How many of the events that follow a host-to-device copy are kernel 1."""
    return sum("event_disparity_scatter" in name for name in after)


def staged_path_order(eng, events):
    """``process_staged`` of each frame's 1-word batch, staged as the pipe
    stages it, under the profiler: (the host-to-device copies that run
    straight into kernel 1, the events that follow the copies)."""
    from xmaps_tpu_torch.io.prefetch import HostStagingPool

    pool = HostStagingPool(eng.cfg.event_capacity, device="cuda", layout=eng.compact_layout)
    # the padding calls take frames too: the len(events) calls between the
    # markers are each frame once
    frames = itertools.cycle(events)
    evs = device_events(lambda: eng.process_staged(pool.stage_compact(next(frames))), len(events))
    after = [evs[i + 1][0] if i + 1 < len(evs) else "(end)"
             for i, (name, _, _) in enumerate(evs) if "HtoD" in name]
    return copies_into_kernel1(after), after


def ring_path_order(eng, raw_path):
    """Every frame the trigger finder emits on the recording, its packets
    staged as the pipe stages them (decoder, activity filter, one 1-word
    ring on the card with room for the whole recording), then
    ``process_ring`` of each frame with its time bounds under the profiler:
    (frames, the host-to-device copies among the calls' device events,
    kernel 1's launches among them, the device events a frame by name)."""
    import torch
    from xmaps_tpu_torch.io.event_iterator import FileEventsIterator
    from xmaps_tpu_torch.io.filters import ActivityNoiseFilter
    from xmaps_tpu_torch.io.prefetch import PacketRing
    from xmaps_tpu_torch.runtime.trigger_finder import RobustTriggerFinder
    from xmaps_tpu_torch.utils.stats import StatsPrinter

    cfg = eng.cfg
    cap = cfg.event_capacity
    ring = PacketRing(packet_capacity=max(2048, cap // 4), n_slots=1024, device="cuda",
                      layout=eng.ring_layout)
    held = []

    def on_frame(evs, gs):
        args = ring.frame(gs, evs, cap)
        if args is None:
            raise AssertionError(f"ring_path_order: frame at {gs} not resident")
        held.append(args)

    act = ActivityNoiseFilter(cfg.camera_width, cfg.camera_height, window_us=int(1e6 / 60),
                              keep_polarity=1)
    finder = RobustTriggerFinder(projector_fps=60, stats=StatsPrinter(silent=True),
                                 frame_callback=None, frame_callback_indexed=on_frame)
    for packet in FileEventsIterator(raw_path, delta_t=1e6 / 60 / 4):
        if len(packet):
            packet = act.process(packet)
            if len(packet) and not ring.stage_packets(packet):
                raise AssertionError("ring_path_order: ring overrun")
            finder.process_events(packet)
    torch.cuda.synchronize()
    frames = itertools.cycle(held)
    evs = device_events(lambda: eng.process_ring(*next(frames)), len(held))
    by_name = collections.Counter(name.replace("(anonymous namespace)::", "")[:50]
                                  for name, _, _ in evs)
    return (len(held), sum("HtoD" in name for name, _, _ in evs),
            sum("event_disparity_scatter" in name for name, _, _ in evs),
            {k: v / len(held) for k, v in by_name.items()})


def phase8_streaming(card, errs):
    """Phase 8: the streaming replay app at the demonstrator rig."""
    import tempfile
    from pathlib import Path

    import torch
    from xmaps_tpu_torch.apps import depth_reprojection as app
    from xmaps_tpu_torch.apps.make_demo_data import write_xmaps_yaml
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
    ring_entry = 0  # kernel 1's ring-entry launches: unfiltered ring frames
    seg = ", prestage=False"
    for name, extra, tail, keys, prestage in (
        ("projector", [], "tail_projector", "", True),
        ("projector" + seg, [], "tail_projector", "", False),
        ("camera", ["--camera-perspective"], "colorize_camera", "", True),
        ("projector --low-latency", ["--low-latency"], "tail_projector", "", True),
        ("projector --low-latency" + seg, ["--low-latency"], "tail_projector", "", False),
        ("projector --profile-dir", ["--profile-dir", str(root / "trace")], "tail_projector",
         "", True),
        ("projector --profile-dir" + seg, ["--profile-dir", str(root / "trace_seg")],
         "tail_projector", "", False),
        # one E key press: the first dedup filter, first_per_yt; from the
        # ring (assembled, the array entry) and staged segmented (2 words)
        ("projector, E key (first_per_yt)", [], "tail_projector", "e", True),
        ("projector, E key (first_per_yt)" + seg, [], "tail_projector", "e", False),
    ):
        rec, counters, loop_s, got = replay(app, base + extra, tail, expect, keys, prestage)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        runs[name] = (rec, counters, loop_s)
        n = len(rec["events"])
        ring = rec["pipe"].ring
        if ring is not None and not keys:
            ring_entry += n
        lat = [(r - t) * 1e3 for t, r in zip(rec["t_trigger"], rec["t_ready"])]
        timers = rec["stats"]._global.times_ns
        staged = (f"ring: {ring.packets_staged} packets staged ({ring.packets_staged / n:.2f} a "
                  f"frame), prestage packet {timers['prestage packet'].mean / 1e6:.4f} ms avg, "
                  f"ring fallback {counters.get('ring fallback', 0)}, overruns "
                  f"{ring.overruns}" if ring is not None else "segmented staging")
        log(f"  {name}: trig ok {counters['trig ok']}, trig fail {counters.get('trig fail', 0)}, "
            f"shown {counters.get('frames shown', 0)} + display skipped "
            f"{counters.get('frames computed (display skipped)', 0)}; launches = frames "
            f"dispatched = {n}; {staged}; replay loop {loop_s:.3f} s: {n / loop_s:.2f} "
            f"frames/s, {counters['processed evs'] / loop_s / 1e6:.2f} Mev/s ingest; trigger -> "
            f"frame ready median {statistics.median(lat):.4f} ms, p90 "
            f"{statistics.quantiles(lat, n=10)[-1]:.4f} ms {card}")

    # every frame of both views, of the segmented and of the filtered
    # replay against the CPU port; the ring replay against the segmented
    # one; 2-word vs 1-word
    for name in ("projector", "projector" + seg, "camera", "projector, E key (first_per_yt)",
                 "projector, E key (first_per_yt)" + seg):
        rec = runs[name][0]
        lit = check_replay_frames(name, rec, errs)
        log(f"  {name}: all {len(lit)} frames bit-equal to the CPU port's process_staged "
            f"(packed BGR + inliers; dispatched {set(rec['how'])}, filter "
            f"{rec['engine'].cfg.frame_filter}); defined pixels {min(lit):.3f}..{max(lit):.3f}")
    for i, (a, b) in enumerate(zip(runs["projector"][0]["results"],
                                   runs["projector" + seg][0]["results"])):
        assert_exact(f"projector frame {i}: ring replay vs prestage=False replay",
                     [(a.frame_bgr, b.frame_bgr), (a.num_inliers, b.num_inliers)])
    log(f"  the ring replay == the prestage=False replay on the card: "
        f"{len(runs['projector'][0]['results'])} frames exact; kernel 1's ring entry launched "
        f"{ring_entry} times in the unfiltered ring replays")
    rec = runs["projector"][0]
    eng = rec["engine"]
    pool = HostStagingPool(eng.cfg.event_capacity, device="cuda")
    for i, (ev, got) in enumerate(zip(rec["events"], rec["results"])):
        assert_exact(f"projector frame {i}: 2-word staging vs the 1-word ring on the card",
                     [(eng.process_staged(pool.stage(ev)).frame_bgr, got.frame_bgr)])
    torch.cuda.synchronize()
    log(f"  2-word staging (stage) == the 1-word ring's frames on the card: "
        f"{len(rec['events'])} frames exact")

    # where a packet's prestaging goes: the projector ring replay again,
    # cProfile on inside PacketRing.stage_packets only
    with profiled_stage_packets() as sp:
        rec, _, loop_s, got = replay(app, base, "tail_projector", expect)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    plain = runs["projector"][0]["stats"]._global.times_ns["prestage packet"].mean / 1e6
    log(f"  PacketRing.stage_packets under cProfile, projector ring replay again: {sp['calls']} "
        f"packets, {sp['events'] / sp['calls']:.0f} events a packet, {sp['wall_ms']:.4f} ms a "
        f"packet profiled ({plain:.4f} unprofiled, `prestage packet` of the projector replay); "
        f"own time a packet, us (cProfile tottime; numpy ufuncs and tensor indexing count in "
        f"their caller): " + ", ".join(f"{name} {us:.1f} ({calls:.2f}x)"
                                     for name, calls, us in sp["top"]) + f" {card}")

    # device time, pinned H2D and busy share from the --profile-dir traces.
    # Segmented: every host-to-device copy the trace holds runs straight
    # into kernel 1.  Ring: the trace's copies are the packets' (at most
    # one a staged packet), none of them a frame's.
    rec, counters, loop_s = runs["projector --profile-dir" + seg]
    n = len(rec["events"])
    dev_ms, h2d_ms, by_name, after = trace_device_ms(root / "trace_seg" / "trace.json")
    fills = [k for k in by_name if is_fill(k)]
    direct = copies_into_kernel1(after)
    if direct != len(after) or fills:
        raise AssertionError(f"profiled segmented replay: {direct} of the trace's {len(after)} "
                             f"H2D copies ({n} frames) run straight into kernel 1 (after them: "
                             f"{sorted(set(after))}); fills {fills}")
    rec_r, _, loop_r = runs["projector --profile-dir"]
    staged_packets = rec_r["pipe"].ring.packets_staged
    dev_r, h2d_r, by_name_r, after_r = trace_device_ms(root / "trace" / "trace.json")
    fills_r = [k for k in by_name_r if is_fill(k)]
    if not 0 < len(after_r) <= staged_packets or fills_r:
        raise AssertionError(f"profiled ring replay: {len(after_r)} H2D copies for "
                             f"{staged_packets} staged packets; fills {fills_r}")
    # in a process of its own: this one's profiler has lost records of
    # copies after the earlier phases (PERF.md section 7)
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--staged-order", raw_path],
                           capture_output=True, text=True, timeout=600)
    order = json.loads(child.stdout.strip().splitlines()[-1]) if child.returncode == 0 else None
    if order is None or order["frames"] != n or order["ring_frames"] != n:
        raise AssertionError(f"chip_smoke.py --staged-order: rc {child.returncode}, "
                             f"{child.stdout[-2000:]}{child.stderr[-2000:]}")
    for what, (d, h, rec_x, lp) in (("segmented", (dev_ms, h2d_ms, rec, loop_s)),
                                    ("ring", (dev_r, h2d_r, rec_r, loop_r))):
        nx = len(rec_x["events"])
        wall_ms = runs["projector"][2] * 1e3 / len(runs["projector"][0]["events"])
        log(f"  {what}: device per frame (profiled replay): {d / nx:.4f} ms, of it H2D "
            f"{h / nx * 1e3:.2f} us; busy share {d / (lp * 1e3):.4f} of the profiled replay "
            f"loop, {d / nx / wall_ms:.4f} of the unprofiled ring one ({wall_ms:.4f} ms/frame) "
            f"{card}")
    log(f"  segmented: all {direct} H2D copies in the trace ({n} frames) run straight into "
        f"kernel 1, no fill; ring: {len(after_r)} H2D copies in the trace for "
        f"{staged_packets} staged packets ({len(after_r) / n:.2f} a frame), no fill")
    log(f"  in a process of its own: process_staged of the {n} frames profiled: "
        f"{order['copies']} H2D copies, one a frame, each straight into kernel 1; "
        f"process_ring of the {order['ring_frames']} frames (their packets staged before): "
        f"{order['ring_copies']} H2D copies, {order['ring_kernel1']} kernel 1 launches; device "
        f"events a ring frame: {order['ring_events']}")
    log("  top device ops a segmented frame: " + ", ".join(
        f"{k[:60]} {v / n * 1e3:.2f} us" for k, v in
        sorted(by_name.items(), key=lambda kv: -kv[1])[:6]))

    # live capture: the app without --input, on the paced synthetic camera:
    # with the PNG sink (every 30th frame fetched and encoded, the others
    # synchronised on their inlier count), and headless, where every frame
    # is fetched to the host as a display would take it
    live = ["--calib", yaml_path, "--capture", "synthetic", "--z-near", str(Z_NEAR),
            "--z-far", str(Z_FAR), "--device", "cuda"]
    files = ["--window", "files", "--out-dir", str(root / "live")]
    for name, extra, prestage in (
            ("live --window files", files, True),
            ("live --window files --low-latency", files + ["--low-latency"], True),
            ("live --window files --low-latency, prestage=False", files + ["--low-latency"],
             False),
            ("live --window none", ["--window", "none"], True)):
        rec, counters, wall_s = live_run(app, live + extra, prestage)
        n = len(rec["events"])
        for k in ("event_disparity_scatter", "tail_projector"):
            launches[k] += n
        lit = check_replay_frames(name, rec, errs)
        lat = [(r - t) * 1e3 for t, r in zip(rec["t_trigger"], rec["t_ready"])]
        ring = rec["pipe"].ring
        staging = (f"ring: {rec['how'].count('ring')} frames from it, ring fallback "
                   f"{counters.get('ring fallback', 0)}, overruns {ring.overruns}, "
                   f"{ring.packets_staged} packets staged" if ring is not None
                   else "segmented staging")
        log(f"  {name} (synthetic camera, paced at 60 Hz, {wall_s:.3f} s): trig ok "
            f"{counters['trig ok']}, trig fail {counters.get('trig fail', 0)}, frames dropped "
            f"{counters.get('frames dropped', 0)}, {staging}; frames computed "
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
                        for k in ("main loop", "act+pol filter", "prestage packet",
                                  "find pauses", "stage batch", "dispatch frame", "fetch stats",
                                  "fetch frame")
                        if k in timers))
    tmp.cleanup()
    log(f"  phase 8 total {time.perf_counter() - t_phase:.1f} s {card}")
    return launches


def live_run(app, argv, prestage=True):
    """One live run of the app's ``main`` on the card (no ``--input``),
    stopped through the processor's ``should_close`` after LIVE_S seconds
    of stream, its stdout kept out of the log, with the launch counts reset
    just before and read just after; ``prestage`` is set on the pipe.
    Returns (record, counters, seconds from the first packet to the
    close)."""
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
        with record_pipe(prestage) as rec, contextlib.redirect_stdout(out):
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
    # the app's engine builds its colorize table once
    want.update(event_disparity_scatter=n, tail_projector=n, colorize_table=1)
    if launches != want:
        raise AssertionError(f"live launches {launches} != {want}")
    return rec, counters, t["last"] - t["first"]


def live_frame_floor(timers, n, wall_s):
    """The fewest frames a paced live run of ``wall_s`` seconds must compute
    at this run's measured host cost, if the watchdog drops no more than its
    design does.  The watchdog drops buffered events while the host is a
    projector period P behind the stream.  A computed frame costs F ms of
    host work on top of the per-packet work p (activity filter, packet-ring
    prestaging, pause search); the host then catches up q - p ms a packet (q: the stream's
    packet interval), so the events of R = F / (q - p) * q / P periods are
    dropped.  Each computed frame thus takes its own period, R periods of
    drops, and at most one more lost to the frame the drops cut (and one for
    rounding R up), so at least (S - 2) / (3 + R) of the S streamed frames
    are computed (the first two lost to the trigger finder's start-up).
    F is all main-loop time not spent on per-packet work (the activity
    filter, the packet-ring prestaging, the pause search), divided by the
    frames computed (it holds launches, the fetch and the display sink, and
    any segmented staging).  Where the host cannot keep up with the packets
    alone, the floor is one frame."""
    packets = timers["act+pol filter"].n
    per_packet = sum(timers[k].total for k in ("act+pol filter", "prestage packet",
                                                "find pauses") if k in timers)
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
    # the loop: a warm-up pass, the synchronous frames and two timed turns;
    # the group: a warm-up call and two timed turns; the bench's two engine
    # setups build a colorize table each
    frames = bench.N_FRAMES + bench.SYNC_FRAMES + 2 * bench.ROUNDS * bench.N_FRAMES
    groups = 1 + 2 * bench.ROUNDS
    want = {k: 0 for k in launches}
    want.update(warmup_add_one=1, event_disparity_scatter=frames, tail_projector=frames,
                event_disparity_scatter_group=groups, tail_projector_group=groups,
                colorize_table=2)
    if rc != 0 or launches != want:
        raise AssertionError(f"apps.bench rc {rc}, launches {launches} != {want}")
    line = out.getvalue().strip().splitlines()[-1]
    result = json.loads(line)
    if not (result["value"] > 0 and result["extra"]["gpu"]
            and result["extra"]["frame_ms_loop"] > 0):
        raise AssertionError(f"apps.bench: {line}")
    log(f"  apps.bench launches {launches}; its JSON line:")
    print(line, flush=True)
    return launches


def float_time(ev):
    """The frame with its times as float32 in [0, 1] (the offline eval's
    scan events): a frame of the other time kind."""
    out = np.zeros(len(ev), dtype=[("x", "<i4"), ("y", "<i4"), ("t", "<f4"), ("p", "<i4")])
    for k in ("x", "y", "p"):
        out[k] = ev[k]
    t = ev["t"].astype(np.float64)
    out["t"] = (t - t.min()) / max(t.max() - t.min(), 1.0)
    return out


def phase9_bench_geometry(card, errs):
    """Phase 9, the geometry bench at the paper's Table-2 rig: one run of
    ``apps.bench_geometry --geometry esl`` a view (12 frames, one
    display-packed group a call), its launches counted from 0 just before
    it and read just after (kernel 1's group entry and the view's tail
    group entry once a call, nothing else but the engine's colorize
    table), its lines printed.  Then, in both views, the bench's
    group (``rig`` + ``make_frames``) on the card, its first 3 frames
    against the CPU port's ``process_frame``, and ``process_frames`` of a
    list mixing integer and float timestamps (one group a time kind)
    against the CPU port, all exact; and the group's device events under
    the profiler (busy ms a frame, by name).  Returns the runs' launches."""
    import torch
    from xmaps_tpu_torch.apps import bench_geometry
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.ops.frame_pipeline import group_depth_frames

    total = collections.Counter()
    calls = 1 + bench_geometry.TRIALS * sum(bench_geometry.ROUNDS)
    for view in (False, True):
        tail = "colorize_camera_group" if view else "tail_projector_group"
        out = io.StringIO()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bench_geometry.main(["--geometry", "esl"]
                                     + (["--camera-perspective"] if view else []))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        want = {k: 0 for k in launches}
        want.update({"event_disparity_scatter_group": calls, tail: calls, "colorize_table": 1})
        lines = out.getvalue().strip().splitlines()
        doc = json.loads(lines[-1])
        if not (rc == 0 and launches == want and doc["rect"] == [5760, 3240]
                and doc["frame_ms"] > 0 and doc["device_ms_per_frame"] > 0
                and 0 < doc["events_per_frame"] <= CAPACITY - 1024
                and doc["gpu"] and doc["power_limit_w"] and doc["camera_perspective"] is view):
            raise AssertionError(f"apps.bench_geometry rc {rc}, launches {launches} != {want}: "
                                 f"{lines}")
        total.update(launches)
        log(f"  apps.bench_geometry --geometry esl{' --camera-perspective' if view else ''} "
            f"({time.perf_counter() - t0:.1f} s) launches {launches}; its lines {card}:")
        for line in lines:
            print(line, flush=True)

    calib = bench_geometry.rig("esl")
    frames = bench_geometry.make_frames(calib, N_FRAMES, CAPACITY)
    mixed = [frames[0], float_time(frames[1]), frames[2]]
    kw = dict(display_only=True, display_packed=True)
    err = 0.0
    for view in (False, True):
        eng = XMapsDepthEngine.from_calibration(
            calib, device="cuda", event_capacity=CAPACITY, z_near=Z_NEAR, z_far=Z_FAR,
            camera_perspective=view, xmap_cache_dir=os.path.expanduser("~/.cache/xmaps_tpu_torch"))
        cpu = eng.to("cpu")
        name = "camera" if view else "projector"
        staged = eng.stage_group(frames)

        def group():
            return group_depth_frames(staged, eng.tables, eng.cfg, eng.plan,
                                      layout=eng.compact_layout, **kw)

        res = group()
        got = eng.process_frames(mixed, **kw)
        for i, (ev, m) in enumerate(zip(frames, mixed)):
            ref = cpu.process_frame(ev, **kw)
            err = max(err, assert_exact(f"ESL bench group ({name}) frame {i} vs the CPU port", [
                (res.frame_bgr[i], ref.frame_bgr), (res.num_inliers[i], ref.num_inliers)]))
            if m is not ev:
                ref = cpu.process_frame(m, **kw)
            err = max(err, assert_exact(f"ESL mixed-time process_frames ({name}) frame {i} vs "
                                        f"the CPU port", [(got[i].frame_bgr, ref.frame_bgr),
                                                          (got[i].num_inliers, ref.num_inliers)]))
        log(f"  {name}: the bench's ESL group, frames 0-2, and process_frames of [int, float, "
            f"int] times (one group a kind) bit-equal to the CPU port; inliers "
            f"{[int(g.num_inliers) for g in got]}")
        dev, by_name = profile_calls(group, 10)
        top = {k.replace("(anonymous namespace)::", "")[:48]: round(v * 1e3 / len(frames), 3)
               for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}
        log(f"  {name}: the bench's ESL group of {len(frames)} ({eng.plan.H}x{eng.plan.W} maps)"
            f" profiled: {dev / len(frames):.5f} ms/frame of device events; us/frame {top} "
            f"{card}")
    for k in ("event_disparity_scatter_group", "tail_projector_group", "colorize_camera_group"):
        errs[k] = max(errs.get(k, 0.0), err)
    return dict(total)


def phase9_bench_stream(card):
    """Phase 9, the streaming bench: one run of ``apps.bench_stream`` (the
    ring and the segmented replays of its synthetic ESL-seq1-like stream in
    real time, and the direct replay alone and under the profiler), whose
    JSON line is printed.  Returns its launches."""
    import torch
    from xmaps_tpu_torch.apps import bench_stream
    from xmaps_tpu_torch.ops import _build

    out = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench_stream.main([])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    line = out.getvalue().strip().splitlines()[-1]
    result = json.loads(line)
    extra = result["extra"]
    frames = launches["event_disparity_scatter"]
    want = {k: 0 for k in launches}
    # the bench's engine builds its colorize table once
    want.update(event_disparity_scatter=frames, tail_projector=frames, colorize_table=1)
    if not (rc == 0 and launches == want and frames >= 6 * extra["frames_measured"] > 0
            and result["value"] > 0 and extra["gpu"] and extra["p50_device_frame_path_ms"]
            and extra["ring_packets_per_frame_mode"] >= 1):
        raise AssertionError(f"apps.bench_stream rc {rc}, launches {launches}: {line}")
    log(f"  apps.bench_stream ({time.perf_counter() - t0:.1f} s) launches {launches}; its JSON "
        f"line {card}:")
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
    cases = ((BENCH_EVENTS, BENCH_SHAPE, False), (5000, (13, 3100), False),
             (300, (3, 5), False), (0, BENCH_SHAPE, False), (BENCH_EVENTS, BENCH_SHAPE, True),
             (200_000, (1024, 1024), False))
    for n, shape, one_cell in cases:
        r, c, v = bench_store_loop.make_inputs(n, shape, seed=n, device="cuda")
        if one_cell:
            r.fill_(5)
            c.fill_(7)
        else:
            r[::53], c[::61] = -2, shape[1]  # events outside the tile
        err = max(err, assert_exact(
            f"tile_store_last {n} events into {shape}{' (one cell)' if one_cell else ''}",
            [(tile_store_last(r, c, v, shape), tile_store_last_plain(r, c, v, shape))]))
    rows, cols, vals = bench_store_loop.make_inputs(BENCH_EVENTS, BENCH_SHAPE, device="cuda")
    err = max(err, assert_exact("tile_store_last at the benchmark's draws", [
        (tile_store_last(rows, cols, vals, BENCH_SHAPE),
         tile_store_last_plain(rows, cols, vals, BENCH_SHAPE))]))
    errs["tile_store_last"] = err
    log(f"phase 10 kernel S tile_store_last {BENCH_EVENTS} events into {BENCH_SHAPE} "
        f"(and ragged shapes, no event, every event into one cell, 1024 x 1024 over several "
        f"clusters, events outside the tile): exact")
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


def tail_library_ms(card, eng_p, packed_p, eng_c, packed_c, library_ms):
    """Phase 6: the PyTorch calls nearest kernels 2 and 3, each checked
    equal to the kernel's result, then timed in turns with it (library,
    kernel, kernel, library; device ms a call).  Kernel 2's dilate half
    (``tail_dilate``, the device event of ``tail_projector``) against
    ``F.max_pool2d(x, 7, 1, 3)`` on the unpacked crop, which computes that
    half only (the ``kernels`` line keeps no library time for kernel 2);
    kernel 3 (display-packed) against ``torch.index_select(bgr_table, 0,
    packed.view(-1) % PACK)`` through the engine's colorize table, the same
    function in a pair of calls: its ``library_ms``."""
    import torch
    import torch.nn.functional as F
    from xmaps_tpu_torch.ops.cuda_tail import colorize_camera, tail_projector
    from xmaps_tpu_torch.ops.image_tail import dilate_max
    from xmaps_tpu_torch.ops.scatter import PACK, unpack_disp

    disp = dict(emit_aux=False, packed_bgr=True)
    x = unpack_disp(packed_p)[None, None]
    assert_exact("F.max_pool2d(x, 7, 1, 3) vs dilate_max",
                 [(F.max_pool2d(x, 7, 1, 3)[0, 0], dilate_max(x[0, 0], 7))])
    table = eng_c.plan.table[0]
    def lookup():
        return torch.index_select(table, 0, packed_c.view(-1) % PACK).view(packed_c.shape)

    assert_exact("torch.index_select(bgr_table, 0, packed % PACK) vs colorize_camera", [
        (lookup(), colorize_camera(packed_c, eng_c.tables, eng_c.plan, **disp)[0])])

    def dilate_ms():
        _, by_name = profile_calls(
            lambda: tail_projector(packed_p, eng_p.tables, eng_p.plan, **disp), 50)
        return sum(v for k, v in by_name.items() if "tail_dilate" in k)

    pool = [device_ms(lambda: F.max_pool2d(x, 7, 1, 3))[0]]
    dil = [dilate_ms(), dilate_ms()]
    pool.append(device_ms(lambda: F.max_pool2d(x, 7, 1, 3))[0])

    def camera():
        return colorize_camera(packed_c, eng_c.tables, eng_c.plan, **disp)

    take = [device_ms(lookup)[0]]
    cam = [device_ms(camera)[0], device_ms(camera)[0]]
    take.append(device_ms(lookup)[0])
    library_ms["colorize_camera"] = statistics.mean(take)
    log(f"  library calls (turns; device ms a call) {card}: kernel 2's dilate half tail_dilate "
        f"{statistics.mean(dil):.5f} {dil} against F.max_pool2d(x, 7, 1, 3) on the unpacked "
        f"{tuple(x.shape[2:])} crop {statistics.mean(pool):.5f} {pool}; kernel 3 "
        f"colorize_camera {statistics.mean(cam):.5f} {cam} against torch.index_select(bgr_table, "
        f"0, packed % PACK) {statistics.mean(take):.5f} {take}")


def run_tool(card, name, main_fn, argv, check):
    """One run of a measurement tool's ``main(argv)`` on the card, its
    launches counted from 0 just before it and read just after; raises
    unless it returns 0 and ``check(doc, launches)`` holds for its last
    (JSON) line.  Prints that line.  Returns (doc, launches)."""
    import torch
    from xmaps_tpu_torch.ops import _build

    out = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    lines = out.getvalue().strip().splitlines()
    doc = json.loads(lines[-1])
    if rc != 0 or doc.get("device") != "cuda" or not doc.get("gpu") or not check(doc, launches):
        raise AssertionError(f"apps.{name} {' '.join(argv)} rc {rc}, launches {launches}: "
                             f"{lines[-12:]}")
    log(f"  apps.{name} {' '.join(argv)} ({time.perf_counter() - t0:.1f} s) launches "
        f"{ {k: v for k, v in launches.items() if v} }; its line {card}:")
    print(lines[-1], flush=True)
    return doc, launches


def phase11_tools(card):
    """Phase 11: the measurement tools on the card, each through its
    ``main`` with its launches counted from 0 just before it and read just
    after: ``apps.check_bitexact --geometry both`` (0 failures over 2
    geometries x 2 views x 3 depths x 4 entries, the launches exactly its
    entries'), ``apps.profile_trace`` at both rigs in both views (a group of
    12, ``classification_ok``), ``apps.profile_stages`` at the demonstrator,
    ``apps.profile_setup`` (warm, in a process of its own: its launches are
    not counted here), ``apps.bench_esl_init`` and ``apps.profile_esl_init``
    (the synthetic ESL rig).  Returns the launches."""
    from xmaps_tpu_torch.apps import (
        bench_esl_init,
        check_bitexact,
        profile_esl_init,
        profile_stages,
        profile_trace,
    )

    t_phase = time.perf_counter()
    total = collections.Counter()
    log(f"phase 11 the measurement tools {card}:")
    runs = 2 * 2 * 3  # geometries x views x depths
    want = {"event_disparity_scatter": 3 * runs, "tail_projector": 3 * runs // 2,
            "colorize_camera": 3 * runs // 2, "event_disparity_scatter_group": 4,
            "tail_projector_group": 2, "colorize_camera_group": 2, "colorize_table": 4}
    _, la = run_tool(card, "check_bitexact", check_bitexact.main, ["--geometry", "both"],
                     lambda d, la: d["value"] == 0 and d["cases"] == runs
                     and {k: v for k, v in la.items() if v} == want)
    total.update(la)
    budgets = {}
    for geometry in ("demo", "esl"):
        for view in (False, True):
            tail = "colorize_camera_group" if view else "tail_projector_group"
            argv = (["--geometry", geometry, "--frames", str(N_FRAMES)]
                    + (["--camera-perspective"] if view else []))
            doc, la = run_tool(
                card, "profile_trace", profile_trace.main, argv,
                lambda d, la, tail=tail: d["classification_ok"] is True
                and la["colorize_table"] == 1 and la["event_disparity_scatter_group"] > 3
                and la[tail] == la["event_disparity_scatter_group"]
                and sum(la.values()) == 1 + 2 * la[tail]
                and d["event_kernel_us"] > 0 and d["tail_kernel_us"] > 0
                and 0 < d["busy_share"] <= 1)
            total.update(la)
            budgets[f"{geometry} {'camera' if view else 'projector'}"] = {
                k: round(doc[k], 4) for k in ("event_kernel_us", "tail_kernel_us",
                                              "outside_kernels_us", "device_ops_total_us",
                                              "module_total_us", "busy_share")}
    log(f"  group-of-{N_FRAMES} stage budgets, us a frame {card}: {budgets}")
    _, la = run_tool(card, "profile_stages", profile_stages.main, [],
                     lambda d, la: d["full_us"] > 0 and d["event_scatter_us"] > 0
                     and d["tail_only_us"] > 0 and d["event_us"] is None
                     and la["event_disparity_scatter"] > 0 and la["tail_projector"] > 0
                     and la["colorize_table"] == 1)
    total.update(la)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "xmaps_tpu_torch.apps.profile_setup"],
                          capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    doc = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
    steps = [k for k, _ in doc.get("engine_build2_steps", {}).items()]
    if not (doc.get("gpu") and doc["cold_caches"] is False and len(steps) == 6
            and doc["kernel_library_s"] > 0 and doc["group12_run_s"] > 0):
        raise AssertionError(f"apps.profile_setup rc {proc.returncode}: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    log(f"  apps.profile_setup, warm, in its own process ({time.perf_counter() - t0:.1f} s); "
        f"its line {card}:")
    print(lines[-1], flush=True)
    for name, fn, check in (
            ("bench_esl_init", bench_esl_init.main,
             lambda d, la: d["bit_equal_to_full"] and d["value"] > 0
             and d["full_surface_ms"] > 0 and la["esl_disparity_search"] > 0
             and la["remap_gather"] == 2 * la["esl_disparity_search"]),
            ("profile_esl_init", profile_esl_init.main,
             lambda d, la: d["ops_total_ms"] > 0 and 0 < d["busy_share"] <= 1
             and any("esl_search" in k for k in d["top"])
             and la["remap_gather"] == 2 * la["esl_disparity_search"] > 0)):
        _, la = run_tool(card, name, fn, [], check)
        total.update(la)
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
    return dict(total)


def remap_library_ms(cam, fwd, disp_box, back):
    """Device ms of torch.take computing kernel B's forward + back remaps
    (an int64 flat index into the source with one zero appended, for the
    -1 destinations of the packed index), the inputs built outside the
    timing."""
    import torch
    from xmaps_tpu_torch.ops.remap import remap_gather_plain

    calls = []
    for src, (idx,) in ((cam, fwd), (disp_box, back)):
        flat = torch.cat([src.reshape(-1), src.new_zeros(1)])
        calls.append((flat, torch.where(idx >= 0, idx.long(), src.numel())))
        assert_exact("torch.take as kernel B's function", [
            (torch.take(*calls[-1]), remap_gather_plain(src, idx))])
    return device_ms(lambda: [torch.take(f, i) for f, i in calls])[0]


def esl_table_elements(cam_box, prep, *, w_clip, min_disp, max_disp, steps):
    """The distinct elements of each of kernel A's tables (G, F, N, R, C)
    that its search reads on ``cam_box``, by table name: the index
    arithmetic of ``ops.esl_search.esl_search_box_plain`` replayed on the
    tensors' device for the nonzero pixels (the kernel returns at once on
    a zero pixel).  G: the search's midpoints and j0; N: j0 and lo; F, R:
    j0 - 1; C: lo - 1, j0 - 1 and hi - 1, each clamped into the row."""
    import torch

    G = prep[0]
    last = G.shape[1] - 1
    rows, cols = torch.nonzero(cam_box, as_tuple=True)
    cam = cam_box[rows, cols]
    row = rows.long() * G.shape[1]
    c = cols.long()
    g = G.reshape(-1)
    lo = c + min_disp
    hi = torch.clamp_max(c + max_disp, w_clip)
    left, right, mids = lo, hi, []
    for _ in range(steps):
        m = torch.clamp_max(torch.div(left + right, 2, rounding_mode="floor"), last)
        mids.append(m)
        cond = g[row + m] >= cam
        right = torch.where(cond, m, right)
        left = torch.where(cond, left, m + 1)
    j0 = torch.minimum(right, hi)
    j0c = torch.clamp_max(j0, last)
    j0m1 = torch.clamp(j0 - 1, 0, last)
    reads = {"G": mids + [j0c], "F": [j0m1], "N": [j0c, torch.clamp_max(lo, last)],
             "R": [j0m1], "C": [torch.clamp(lo - 1, 0, last), j0m1, torch.clamp(hi - 1, 0, last)]}
    return {k: int(torch.unique(torch.cat([row + j for j in js])).numel())
            for k, js in reads.items()}


def distinct_disparities(packed) -> int:
    """How many distinct disparities (``packed & (PACK - 1)``) a packed map
    holds: the colorize table entries kernel 3 reads on it."""
    import torch
    from xmaps_tpu_torch.ops.scatter import PACK

    return int(torch.unique(packed & (PACK - 1)).numel())


def projector_disparities(packed, tables, plan) -> int:
    """How many distinct disparities kernel 2's output shows for the packed
    crop (H, W) or crops (F, H, W): the colorize table entries it reads
    (the plain version's disparity plane, which the card's equals)."""
    import torch
    from xmaps_tpu_torch.ops.cuda_tail import tail_projector_plain

    crops = packed if packed.dim() == 3 else packed[None]
    return int(torch.unique(torch.cat([
        tail_projector_plain(c, tables, plan)[2].flatten() for c in crops])).numel())


def kernel_bytes(name, shapes) -> float:
    """The bytes ``name`` must move on the main path's inputs of this run:
    each input read once, each output written once; for gathers, one
    element per lane that needs it (at most the whole table)."""
    s = shapes[name]
    if name == "event_disparity_scatter":
        n, inl, lut_b, xmap_b, out_px = s
        return 13 * n + min(4 * inl, lut_b) + min(2 * inl, xmap_b) + 4 * out_px + 4
    if name == "event_disparity_scatter_staged":
        # the 1-word batch: 4 B an event read, its two gathers, the map
        # written, the count written (the host passes it)
        n, lut_b, xmap_b, out_px = s
        return 4 * n + min(4 * n, lut_b) + min(2 * n, xmap_b) + 4 * out_px + 4
    if name == "tail_projector":
        # the crop in, the two i16 maps, packed BGR out, and the table
        # entries of the distinct disparities the frame shows (BGR, and
        # depth where it is written)
        crop_px, proj_px, distinct, with_depth = s
        return 4 * crop_px + 2 * 2 * proj_px + 4 * distinct * (2 if with_depth else 1) + 4 * proj_px
    if name == "colorize_camera":
        # the map in, packed BGR out, and the table entries of the distinct
        # disparities the map holds (BGR, and depth where it is written)
        px, distinct, with_depth = s
        return 4 * px + 4 * distinct * (2 if with_depth else 1) + 4 * px
    if name == "event_disparity_scatter_group":
        # the staged rows: 4 B an event read, its two gathers, each map
        # written and each count read and written (F x the staged frame's)
        counts, lut_b, xmap_b, out_px = s
        return sum(4 * n + min(4 * n, lut_b) + min(2 * n, xmap_b) + 4 * out_px + 8
                   for n in counts)
    if name == "tail_projector_group":
        # each crop in and each frame's packed BGR out; the maps and the
        # table entries of the group's distinct disparities once a group
        f, crop_px, proj_px, distinct = s
        return f * (4 * crop_px + 4 * proj_px) + 2 * 2 * proj_px + 4 * distinct
    if name == "colorize_camera_group":
        px, distinct = s
        return sum(kernel_bytes("colorize_camera", {"colorize_camera": (px, d, False)})
                   for d in distinct)
    if name == "colorize_table":
        # the TURBO LUT in, the BGR and depth tables out
        (n,) = s
        return 4 * 256 + 8 * n
    if name == "esl_disparity_search":
        # the box in and out, and each distinct table element the search
        # reads on this run's box (esl_table_elements)
        box_px, elements = s
        return 8 * box_px + 4 * sum(elements.values())
    if name == "remap_gather":
        # per call (destination px, valid px, source px): the packed int32
        # index in, one source element per valid lane, the f32 plane out
        return sum(4 * px + 4 * min(n_in, src_px) + 4 * px for px, n_in, src_px in s)
    if name in ("frame_dedup_filter", "frame_dedup_filter_group"):
        # a frame's (lanes, positive lanes, LUT bytes, mean filter): x, y,
        # p and valid read, valid and the priority written (18 B a lane);
        # first_per_yt's positive lanes read their LUT entries, the mean
        # filter reads and writes t
        return sum(18 * n + min(4 * pos, lut_b) + (8 * n if mean else 0)
                   for n, pos, lut_b, mean in s)
    if name == "esl_refine":
        # a call (F, H, W, optimised px, w, iters): depth0 and the camera
        # image in, the refined depth out, the rays once
        f, h, w, _, _, _ = s
        return 12 * f * h * w + 8 * h * w
    if name == "warmup_add_one":
        (n,) = s
        return 8 * n
    if name == "tile_store_last":
        # rows, cols and vals in (12 B an event), the tile out
        n, h, w = s
        return 12 * n + 4 * h * w
    raise KeyError(name)


def esl_refine_ops(shape) -> float:
    """Kernel R's FP32 operations a call of ``shape`` (``kernel_bytes``'):
    the optimised pixels' stencils, set-up and 2 (iters + 1) samples."""
    _, _, _, px, w, iters = shape
    return px * ((2 * w + 1) ** 2 * ESL_REFINE_OPS_A_TAP + ESL_REFINE_OPS_A_PIXEL
                 + 2 * (iters + 1) * ESL_REFINE_OPS_A_SAMPLE)


def kernel_bound_ms(name, shapes) -> tuple:
    """(the least ms the card could take for ``name`` on this run's inputs,
    what bounds it): its bytes over the HBM rate, and for kernel R the
    larger of that and its FP32 operations over the FP32 issue rate."""
    by_bytes = kernel_bytes(name, shapes) / HBM_BYTES_PER_S * 1e3
    if name != "esl_refine":
        return by_bytes, "bytes"
    by_ops = esl_refine_ops(shapes[name]) / FP32_OPS_PER_S * 1e3
    return (by_ops, "fp32 issue") if by_ops > by_bytes else (by_bytes, "bytes")


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
        build_colorize_table,
        colorize_camera,
        colorize_camera_plain,
        colorize_table_plain,
        tail_projector,
        tail_projector_plain,
    )
    from xmaps_tpu_torch.ops.filters import FILTER_NAMES
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
        staged[name] = kernel_parity(eng, frames[0], errs, frames)
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
    engines = {"projector": eng_p, "camera": eng_c}
    log(f"  (phases 1-5 done at {time.perf_counter() - t_start:.1f} s)")
    group_launches, groups = phase4b_group(card, errs, engines, frames, eng_e, esl_frames)
    for k, v in group_launches.items():
        launches[k] += v
    log(f"  (phase 4b done at {time.perf_counter() - t_start:.1f} s)")
    for k, v in phase4c_mesh(card, errs, engines, frames, eng_e, esl_frames).items():
        launches[k] += v
    for k, v in phase_filters(card, errs, {"projector": eng_p, "camera": eng_c}, frames,
                              eng_e, esl_frames).items():
        launches[k] += v

    log(f"  (phases 4c, 5b done at {time.perf_counter() - t_start:.1f} s)")

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
        tail = {k.replace("(anonymous namespace)::", "")[:40]: round(v * 1e3, 3)
                for k, v in by_name.items() if "colorize" in k or "tail_" in k}
        log(f"      the tail kernel(s), us/frame: {tail}")
        frame_fills, batch_fills = (fills_a_call(fn) for fn in (
            lambda: eng.process_frame(geo_frames[0], display_only=True, display_packed=True),
            lambda: eng.make_batch(geo_frames[0])))
        if frame_fills != batch_fills:
            raise AssertionError(f"{name}: fills a frame {frame_fills} != the batch's "
                                 f"{batch_fills}: a fill runs in the frame program")
        log(f"      fills a frame {frame_fills}, all in make_batch (EventBatch.from_arrays); "
            f"none in the frame program")
    log(f"  (phase 6 frames done at {time.perf_counter() - t_start:.1f} s)")
    kernels_ms: dict = {}
    filter_shapes: dict = {}
    time_filters(card, "projector", eng_p, frames, FILTER_NAMES[1:], kernels_ms, filter_shapes)
    time_filters(card, "camera", eng_c, frames, FILTER_NAMES[1:])
    time_filters(card, "esl_projector", eng_e, esl_frames, ["first_per_yt"], {})
    log(f"  (phase 6 filters done at {time.perf_counter() - t_start:.1f} s)")

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
    kernels_ms["colorize_table"] = time_pair(
        lambda: build_colorize_table(eng_c.tables, eng_c.plan),
        lambda: colorize_table_plain(eng_c.tables, eng_c.plan),
    )
    # bounds: this run's inputs (kernel 1: the projector-view frame 0)
    t = eng_p.tables
    shapes = {
        "event_disparity_scatter": (
            batch.capacity, int(batch.valid.sum()),
            t.cam_map_packed.numel() * 4, t.x_map.numel() * 2, packed_p.numel()),
        "tail_projector": (packed_p.numel(), t.proj_mapx_i16.numel(),
                           projector_disparities(packed_p, t, eng_p.plan), False),
        "colorize_camera": (packed_c.numel(), distinct_disparities(packed_c), False),
        "colorize_table": (eng_c.plan.table[0].numel(),),
        **filter_shapes,
    }
    log(f"  kernel 3's bound reads {shapes['colorize_camera'][1]} BGR table entries: the "
        f"distinct disparities of the camera-view map")
    library_ms: dict = {}
    for k, (km, pm) in kernels_ms.items():
        log(f"  kernel {k}: {km['ms']:.5f} ms device ({km['source']}), plain "
            f"{pm['ms']:.5f} ms; issue rate {km['issue_ms']:.5f} vs {pm['issue_ms']:.5f} "
            f"ms/call (demonstrator, display-packed, mean of 2x50 calls) {card}")
    tail_library_ms(card, eng_p, packed_p, eng_c, packed_c, library_ms)
    time_kernel1_entries(card, eng_p, frames[0], batch, t_bin, ekw, shapes)
    time_offset_entry(card, eng_p, batch, t_bin, ekw)
    log(f"  (phase 6 kernels 1-3 and their library calls done at "
        f"{time.perf_counter() - t_start:.1f} s)")
    time_group(card, engines, frames, kernels_ms, shapes, groups)
    esl_group = make_frames(esl, N_FRAMES, 0.031, target=CAPACITY - 1024)
    time_kernel1_esl(card, eng_e, esl_group)
    time_kernel2_esl(card, eng_e, esl_group)
    log(f"  (phase 6 groups and ESL kernels done at {time.perf_counter() - t_start:.1f} s)")
    time_mesh(card)
    for eng in (eng_p, eng_c):
        time_ring_vs_staged(card, eng, frames)

    log(f"  (phase 6 done at {time.perf_counter() - t_start:.1f} s)")

    # -- 7-11. the offline eval, the replay app, the benches, the tools --
    # launches: the engine's main path (phase 4), the group's (phase 4b),
    # the virtual meshes' (phase 4c), the filters' (phase 5b) plus the eval
    # apps' and the sharded eval loop's (phase 7), the replay and live
    # app's (phase 8), the benches' (phase 9) and the store-loop bench's
    # (phase 10) and the measurement tools' (phase 11), each counted from 0
    # just before its run
    for part in (phase7_offline_eval(card, errs, kernels_ms, shapes, library_ms),
                 phase8_streaming(card, errs),
                 phase9_bench(card, errs, kernels_ms, shapes, library_ms),
                 phase9_bench_geometry(card, errs),
                 phase9_bench_stream(card),
                 phase10_store_loop(card, errs, kernels_ms, shapes, library_ms),
                 phase11_tools(card)):
        for k, v in part.items():
            launches[k] += v
    log(f"launches on the main paths (phases 4, 4b, 4c, 5b, 7, 8, 9, 10, 11): {launches}")

    kernels = []
    for k in KERNEL_INFO:
        bound_ms, bound_by = kernel_bound_ms(k, shapes)
        kernels.append(dict(
            name=k, route="cuda", source=KERNEL_INFO[k][0],
            replaces=KERNEL_INFO[k][1], launches=launches[k],
            max_abs_err=errs[k], ms=kernels_ms[k][0]["ms"],
            plain_ms=kernels_ms[k][1]["ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms.get(k)))
        km = kernels_ms[k][0]
        top = f"; device events of the second, ms a call: {km['top']}" if km["top"] else ""
        log(f"  kernel {k}: {kernels[-1]['ms']:.5f} ms (turns {km['turns'][0]:.5f}, "
            f"{km['turns'][1]:.5f}{top}), "
            f"bound {bound_ms:.6f} ms ({bound_by}), share of bound "
            f"{bound_ms / kernels[-1]['ms']:.4f},"
            f" library {library_ms.get(k)} ms {card}")
    over = {k["name"]: round(k["bound_ms"] / k["ms"], 4) for k in kernels
            if k["bound_ms"] > MAX_SHARE * k["ms"]}
    if over:
        raise AssertionError(f"kernels faster than their bound (share over {MAX_SHARE}): "
                             f"{over}: the bound or the timing is wrong")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def staged_order_main(raw_path) -> int:
    """``python3 chip_smoke.py --staged-order RAW`` (phase 8 runs it): the
    frames the trigger finder emits on the demonstrator recording RAW
    through ``process_staged`` of a fresh demonstrator engine, profiled,
    then through ``process_ring`` on their staged packets, profiled.
    Prints one JSON line; exits 1 unless each segmented frame's one
    host-to-device copy runs straight into kernel 1, and the ring frames'
    calls hold no host-to-device copy and one kernel 1 launch a frame."""
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration

    root = os.path.dirname(os.path.abspath(__file__))
    eng = XMapsDepthEngine.from_calibration(
        make_synthetic_calibration(640, 480, 720, 1280), device="cuda", event_capacity=CAPACITY,
        z_near=Z_NEAR, z_far=Z_FAR, xmap_cache_dir=os.path.join(root, "build", "xmaps_tpu_torch",
                                                               "cache"))
    frames = segment_host(raw_path, 60, 640, 480)
    direct, after = staged_path_order(eng, frames)
    ring_frames, ring_copies, ring_kernel1, ring_events = ring_path_order(eng, raw_path)
    print(json.dumps(dict(frames=len(frames), copies=len(after), direct=direct,
                          after=sorted(set(after)), ring_frames=ring_frames,
                          ring_copies=ring_copies, ring_kernel1=ring_kernel1,
                          ring_events=ring_events)), flush=True)
    return 0 if (direct == len(after) == len(frames) == ring_frames == ring_kernel1
                 and ring_copies == 0) else 1


if __name__ == "__main__":
    sys.exit(staged_order_main(sys.argv[2]) if sys.argv[1:2] == ["--staged-order"] else main())
