"""Kernel 1 wrapper: per-event rectify + X-map gather + packed scatter.

``event_disparity_scatter`` turns one frame's events and their X-map time
bins into the packed int32 disparity map (crop of the rectified frame for
the projector view, the camera frame for the camera view) and the inlier
count.  On CUDA tensors it launches ``csrc/events.cu`` (replacing the TPU
kernels ``rectify_and_lookup`` / ``rectify_and_lookup_hbm``); on CPU tensors
it runs the plain version, ``compute_event_disparity`` +
``scatter_disp_packed``.  The last-write-wins priority is the lane index,
or a per-lane int32 ``priority`` (the dedup filters' dense raster rank,
``ops.filters``).  The array entries take an ``index_offset`` that shifts
the lane index: an event shard of a frame (``parallel.sharding``) passes
its first lane, so its keys are the frame's and the shards' maps combine
with an unsigned max into the frame's map.

``event_disparity_scatter_staged`` is the same kernel on the streaming
path's 1-word staged batch (``ops.staged.CompactStagedBatch``): it decodes
x, y and the time bin of each lane below the host count in registers, so
nothing runs between the batch's host-to-device copy and the kernel.  Its
plain version is ``unpack_staged_compact`` + the plain scatter.

``event_disparity_scatter_ring`` is the same kernel on the packet ring's
device rows (``io.prefetch.PacketRing`` with a ``RingLayout``): the k <= 8
packets' rows and their placement go in as kernel arguments, each lane
finds its packet, decodes its word and bins its time from the frame's host
time bounds in registers, so nothing crosses the link at dispatch.  Its
plain version is the compact ring assembly, ``scale_time`` and the plain
scatter.

``event_disparity_scatter_group`` and ``event_disparity_scatter_staged_group``
run F independent frames in one launch (``process_frames``): the array
entry over an ``EventBatch`` with a leading frame axis, the staged entry
over ``io.prefetch.stage_compact_group``'s rows and device counts.  They
return (F, out_h, out_w) maps and (F,) counts, each frame equal to its
one-frame entry's; their plain versions run the one-frame plain version on
each frame and stack the results.

The map and the count are zeroed inside the kernel's cooperative launch:
both are allocated with ``torch.empty``, and no fill runs on the path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from xmaps_tpu_torch.ops import _build
from xmaps_tpu_torch.ops.disparity import compute_event_disparity, scale_time
from xmaps_tpu_torch.ops.event_batch import EventBatch
from xmaps_tpu_torch.ops.scatter import MAX_CAPACITY, scatter_disp_packed
from xmaps_tpu_torch.ops.staged import (
    RING_SLOTS_PER_FRAME,
    CompactLayout,
    CompactStagedBatch,
    CompactStagedGroup,
    RingLayout,
    assemble_ring_frame_compact,
    unpack_staged_compact,
)

__all__ = [
    "EventScatterResult",
    "event_disparity_scatter",
    "event_disparity_scatter_plain",
    "event_disparity_scatter_staged",
    "event_disparity_scatter_staged_plain",
    "event_disparity_scatter_ring",
    "event_disparity_scatter_ring_plain",
    "event_disparity_scatter_group",
    "event_disparity_scatter_group_plain",
    "event_disparity_scatter_staged_group",
    "event_disparity_scatter_staged_group_plain",
]

#: a group's lanes (F x capacity) stay well inside the kernel's int walk
MAX_GROUP_LANES = 1 << 30


class EventScatterResult(NamedTuple):
    packed_map: torch.Tensor  # (out_h, out_w) int32 holding uint32 words
    num_inliers: torch.Tensor  # 0-dim int32
    #: per-lane (x_rect, y_rect, x_proj) int32, only when requested
    lanes: Optional[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def event_disparity_scatter_plain(
    batch: EventBatch,
    t_bin: torch.Tensor,
    tables,
    *,
    camera_view: bool,
    window: tuple[int, int],
    out_shape: tuple[int, int],
    want_lanes: bool = False,
    priority: Optional[torch.Tensor] = None,
    index_offset: int = 0,
) -> EventScatterResult:
    """Plain PyTorch version of ``event_disparity_scatter`` (any device)."""
    res = compute_event_disparity(
        batch,
        tables.cam_mapx_i16,
        tables.cam_mapy_i16,
        tables.x_map,
        t_px_scale=0,  # unused: the time bins are given
        t_scaled=t_bin,
    )
    oy, ox = window
    out_h, out_w = out_shape
    if camera_view:
        ys, xs = batch.y, batch.x
    else:
        ys, xs = res.y_rect, res.x_rect + res.disp.int()
    packed = scatter_disp_packed(
        ys - oy, xs - ox, res.disp, res.inlier, height=out_h, width=out_w,
        priority=priority, index_offset=index_offset,
    )
    lanes = (res.x_rect, res.y_rect, res.x_proj) if want_lanes else None
    return EventScatterResult(packed, res.inlier.sum().int(), lanes)


def event_disparity_scatter(
    batch: EventBatch,
    t_bin: torch.Tensor,
    tables,
    *,
    camera_view: bool,
    window: tuple[int, int],
    out_shape: tuple[int, int],
    want_lanes: bool = False,
    priority: Optional[torch.Tensor] = None,
    index_offset: int = 0,
) -> EventScatterResult:
    """One frame's events -> packed disparity map + inlier count.

    ``t_bin``: (N,) int32 X-map time bins (``ops.disparity.scale_time``).
    ``tables``: ``ops.frame_pipeline.DeviceTables`` on the batch's device.
    ``window``: (oy, ox) origin of the map in target coordinates;
    ``out_shape``: (out_h, out_w) of the map; targets outside are dropped.
    ``want_lanes`` also returns the per-lane (x_rect, y_rect, x_proj).
    ``priority``: (N,) int32 last-write-wins priority, each value below
    ``MAX_CAPACITY`` (None: the lane index plus ``index_offset``).  An
    event shard's priorities are its frame's (a dedup filter's global
    rank, ``parallel.sharding``), so they may exceed its own N.
    ``index_offset``: the lane index's shift, the shard's first lane in
    its frame (``scatter_disp_packed(index_offset=)``), with the lanes
    ``index_offset + N <= MAX_CAPACITY``; a given priority ignores it.
    """
    dev = batch.x.device
    n = batch.x.shape[0]
    _check_offset("event_disparity_scatter", index_offset, n)
    if dev.type == "cpu":
        return event_disparity_scatter_plain(
            batch, t_bin, tables, camera_view=camera_view, window=window,
            out_shape=out_shape, want_lanes=want_lanes, priority=priority,
            index_offset=index_offset,
        )
    if dev.type != "cuda":
        raise ValueError(f"event_disparity_scatter: unsupported device {dev}")
    checked = [
        ("x", batch.x, torch.int32),
        ("y", batch.y, torch.int32),
        ("t_bin", t_bin, torch.int32),
        ("valid", batch.valid, torch.bool),
        ("cam_map_packed", tables.cam_map_packed, torch.int32),
        ("x_map", tables.x_map, torch.int16),
    ]
    if priority is not None:
        checked.append(("priority", priority, torch.int32))
    for name, a, dtype in checked:
        if a.device != dev or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(
                f"event_disparity_scatter: {name} must be a contiguous {dtype} "
                f"tensor on {dev}, got {a.dtype} on {a.device}"
            )
    for name, a, _ in checked:
        if name not in ("cam_map_packed", "x_map") and a.shape != (n,):
            raise ValueError(f"event_disparity_scatter: {name} shape {tuple(a.shape)} != ({n},)")
    out_h, out_w = out_shape
    packed, count = _outputs(out_shape, dev)
    lanes = None
    lane_ptrs = (None, None, None)
    if want_lanes:
        lanes = tuple(torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3))
        lane_ptrs = tuple(a.data_ptr() for a in lanes)
    cam_h, cam_w = tables.cam_map_packed.shape
    xmap_h, xmap_w = tables.x_map.shape
    oy, ox = window
    prio_ptr = None if priority is None else priority.data_ptr()
    _build.launch(
        dev, "event_disparity_scatter", "event_disparity_scatter",
        batch.x.data_ptr(), batch.y.data_ptr(), t_bin.data_ptr(),
        batch.valid.data_ptr(), prio_ptr, n, index_offset,
        tables.cam_map_packed.data_ptr(), cam_h, cam_w,
        tables.x_map.data_ptr(), xmap_h, xmap_w,
        int(camera_view), oy, ox, out_h, out_w,
        packed.data_ptr(), count.data_ptr(), *lane_ptrs,
    )
    return EventScatterResult(packed, count, lanes)


def _outputs(out_shape: tuple[int, int], dev, frames: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's packed map and inlier count (with ``frames``, F maps
    and F counts), left unzeroed: the launch zeroes them.  (``torch.empty``
    is 16-byte aligned, as the kernel's vector zeroing needs.)"""
    lead = (frames,) if frames else ()
    return (torch.empty((*lead, *out_shape), dtype=torch.int32, device=dev),
            torch.empty(lead, dtype=torch.int32, device=dev))


def _check_offset(kernel: str, index_offset: int, n: int) -> None:
    """The packed key's priority (lane + offset + 1) must fit the uint32
    word: ``index_offset + n <= MAX_CAPACITY``."""
    if index_offset < 0 or index_offset + n > MAX_CAPACITY:
        raise ValueError(
            f"{kernel}: lanes [{index_offset}, {index_offset + n}) overflow the uint32 "
            f"packing (offset >= 0, offset + capacity at most {MAX_CAPACITY})")


def _check_tables(kernel: str, tables, dev) -> None:
    for name, a, dtype in (("cam_map_packed", tables.cam_map_packed, torch.int32),
                           ("x_map", tables.x_map, torch.int16)):
        if a.device != dev or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous {dtype} tensor on {dev}, "
                             f"got {a.dtype} on {a.device}")


def _group_shape(kernel: str, rows: torch.Tensor) -> tuple[int, int]:
    """(F, capacity) of a group's (F, capacity) lane rows, checked."""
    if rows.dim() != 2 or rows.shape[0] < 1:
        raise ValueError(f"{kernel}: lanes must be (F, capacity) rows with F >= 1, "
                         f"got {tuple(rows.shape)}")
    f, cap = rows.shape
    if not 1 <= cap <= MAX_CAPACITY or f * cap > MAX_GROUP_LANES:
        raise ValueError(f"{kernel}: {f} x {cap} lanes (capacity 1..{MAX_CAPACITY}, at most "
                         f"{MAX_GROUP_LANES} in all)")
    return f, cap


def _stack(results) -> EventScatterResult:
    return EventScatterResult(torch.stack([r.packed_map for r in results]),
                              torch.stack([r.num_inliers for r in results]))


def event_disparity_scatter_staged_plain(
    word: torch.Tensor,
    count: int,
    layout: CompactLayout,
    tables,
    *,
    camera_view: bool,
    window: tuple[int, int],
    out_shape: tuple[int, int],
) -> EventScatterResult:
    """Plain PyTorch version of ``event_disparity_scatter_staged`` (any
    device): the device-side unpack, then the plain scatter."""
    batch, t_bin = unpack_staged_compact(CompactStagedBatch(word, count), layout)
    return event_disparity_scatter_plain(
        batch, t_bin, tables, camera_view=camera_view, window=window, out_shape=out_shape,
    )


def event_disparity_scatter_staged(
    word: torch.Tensor,
    count: int,
    layout: CompactLayout,
    tables,
    *,
    camera_view: bool,
    window: tuple[int, int],
    out_shape: tuple[int, int],
) -> EventScatterResult:
    """One frame's 1-word staged batch -> packed disparity map + inlier
    count, equal to ``event_disparity_scatter`` on the unpacked batch.

    ``word``: (capacity,) int32 words ``x | y << bits_x | t_bin << (bits_x
    + bits_y)`` (``io.prefetch.HostStagingPool.stage_compact``); ``count``:
    the host count, lanes below it valid; ``layout``: the bit widths.
    """
    dev = word.device
    if dev.type == "cpu":
        return event_disparity_scatter_staged_plain(
            word, count, layout, tables, camera_view=camera_view, window=window,
            out_shape=out_shape,
        )
    if dev.type != "cuda":
        raise ValueError(f"event_disparity_scatter_staged: unsupported device {dev}")
    n = word.shape[0]
    if word.dtype != torch.int32 or word.dim() != 1 or not word.is_contiguous():
        raise ValueError(f"event_disparity_scatter_staged: word must be a contiguous 1-d "
                         f"int32 tensor, got {tuple(word.shape)} {word.dtype}")
    if n > MAX_CAPACITY or not 0 <= count <= n:
        raise ValueError(f"event_disparity_scatter_staged: count {count} outside [0, {n}] "
                         f"or capacity {n} over {MAX_CAPACITY}")
    bits = (layout.bits_x, layout.bits_y, layout.bits_t)
    if min(bits) < 1 or sum(bits) > 32:
        raise ValueError(f"event_disparity_scatter_staged: layout widths {bits}")
    _check_tables("event_disparity_scatter_staged", tables, dev)
    packed, inliers = _outputs(out_shape, dev)
    cam_h, cam_w = tables.cam_map_packed.shape
    xmap_h, xmap_w = tables.x_map.shape
    (oy, ox), (out_h, out_w) = window, out_shape
    _build.launch(
        dev, "event_disparity_scatter", "event_disparity_scatter_staged",
        word.data_ptr(), count, *bits,
        tables.cam_map_packed.data_ptr(), cam_h, cam_w,
        tables.x_map.data_ptr(), xmap_h, xmap_w,
        int(camera_view), oy, ox, out_h, out_w,
        packed.data_ptr(), inliers.data_ptr(),
    )
    return EventScatterResult(packed, inliers)


def event_disparity_scatter_ring_plain(
    rows,
    meta: np.ndarray,
    count: int,
    t_bounds: tuple[int, int],
    layout: RingLayout,
    tables,
    *,
    t_px_scale: int,
    camera_view: bool,
    window: tuple[int, int],
    out_shape: tuple[int, int],
) -> EventScatterResult:
    """Plain PyTorch version of ``event_disparity_scatter_ring`` (any
    device): the compact ring assembly of the frame's ``count`` lanes, the
    time binning (``scale_time``, which takes the bounds from the batch
    itself: ``t_bounds`` is what the kernel must agree with), then the
    plain scatter.  Lanes past the count would be padding, which no result
    depends on, so the batch holds just the ``count`` lanes."""
    del t_bounds
    batch = assemble_ring_frame_compact(rows, meta, count, layout)
    t_bin = scale_time(batch.t, batch.valid, t_px_scale)
    return event_disparity_scatter_plain(
        batch, t_bin, tables, camera_view=camera_view, window=window, out_shape=out_shape,
    )


def event_disparity_scatter_ring(
    rows,
    meta: np.ndarray,
    count: int,
    t_bounds: tuple[int, int],
    layout: RingLayout,
    tables,
    *,
    t_px_scale: int,
    camera_view: bool,
    window: tuple[int, int],
    out_shape: tuple[int, int],
) -> EventScatterResult:
    """One frame read straight from the packet ring -> packed disparity map
    + inlier count, equal to ``event_disparity_scatter`` on the assembled
    batch and its time bins.

    ``rows``: the k packets' device rows (``RingPacket.xy``, int32 words
    ``x | y << bits_x | t_rel << (bits_x + bits_y)``); ``meta``: the host
    (3, k) int32 placement of ``PacketRing.frame_meta`` (start lanes,
    counts, time offsets); ``count``: ``min(frame events, capacity)``, the
    lanes read; ``t_bounds``: the host (min, max) of the frame's times over
    those lanes relative to its first event (``io.prefetch.ring_time_bounds``).
    The rows must be on the tables' device, and the copies that filled them
    on the current stream.
    """
    k = len(rows)
    if not 1 <= k <= RING_SLOTS_PER_FRAME or meta.shape != (3, k):
        raise ValueError(f"event_disparity_scatter_ring: {k} packets (1..{RING_SLOTS_PER_FRAME})"
                         f" with meta {meta.shape}")
    starts, counts, t_offs = (np.ascontiguousarray(m, dtype=np.int32) for m in meta)
    total = int(counts.sum())
    if not 1 <= count <= min(total, MAX_CAPACITY):
        raise ValueError(f"event_disparity_scatter_ring: count {count} outside [1, "
                         f"min({total}, {MAX_CAPACITY})]")
    dev = rows[0].device
    if dev.type == "cpu":
        return event_disparity_scatter_ring_plain(
            rows, meta, count, t_bounds, layout, tables, t_px_scale=t_px_scale,
            camera_view=camera_view, window=window, out_shape=out_shape,
        )
    if dev.type != "cuda":
        raise ValueError(f"event_disparity_scatter_ring: unsupported device {dev}")
    for row, s, c in zip(rows, starts, counts):
        if (row.device != dev or row.dtype != torch.int32 or row.dim() != 1
                or not row.is_contiguous() or s < 0 or c < 1 or s + c > row.shape[0]):
            raise ValueError(f"event_disparity_scatter_ring: a packet row {row.dtype} "
                             f"{tuple(row.shape)} on {row.device} (lanes [{s}, {s + c}))"
                             f" is not a contiguous int32 row on {dev} holding them")
    bits = (layout.bits_x, layout.bits_y, layout.bits_t)
    if min(bits) < 1 or sum(bits) > 32:
        raise ValueError(f"event_disparity_scatter_ring: layout widths {bits}")
    t_min, t_max = (int(v) for v in t_bounds)
    if t_min > t_max:
        raise ValueError(f"event_disparity_scatter_ring: t_bounds {t_bounds}")
    _check_tables("event_disparity_scatter_ring", tables, dev)
    packed, inliers = _outputs(out_shape, dev)
    cam_h, cam_w = tables.cam_map_packed.shape
    xmap_h, xmap_w = tables.x_map.shape
    (oy, ox), (out_h, out_w) = window, out_shape
    ptrs = (ctypes.c_void_p * k)(*(row.data_ptr() for row in rows))
    _build.launch(
        dev, "event_disparity_scatter", "event_disparity_scatter_ring",
        ctypes.addressof(ptrs), starts.ctypes.data, counts.ctypes.data, t_offs.ctypes.data,
        k, count, layout.bits_x, layout.bits_y, t_min, t_max, t_px_scale,
        tables.cam_map_packed.data_ptr(), cam_h, cam_w,
        tables.x_map.data_ptr(), xmap_h, xmap_w,
        int(camera_view), oy, ox, out_h, out_w,
        packed.data_ptr(), inliers.data_ptr(),
    )
    return EventScatterResult(packed, inliers)


def event_disparity_scatter_group_plain(
    batch: EventBatch,
    t_bin: torch.Tensor,
    tables,
    *,
    camera_view: bool,
    window: tuple[int, int],
    out_shape: tuple[int, int],
    priority: Optional[torch.Tensor] = None,
    index_offset: int = 0,
) -> EventScatterResult:
    """Plain PyTorch version of ``event_disparity_scatter_group`` (any
    device): the one-frame plain version on each frame, stacked."""
    f, _ = _group_shape("event_disparity_scatter_group", batch.x)
    return _stack([
        event_disparity_scatter_plain(
            batch.frame(i), t_bin[i], tables, camera_view=camera_view, window=window,
            out_shape=out_shape, priority=None if priority is None else priority[i],
            index_offset=index_offset,
        )
        for i in range(f)
    ])


def event_disparity_scatter_group(
    batch: EventBatch,
    t_bin: torch.Tensor,
    tables,
    *,
    camera_view: bool,
    window: tuple[int, int],
    out_shape: tuple[int, int],
    priority: Optional[torch.Tensor] = None,
    index_offset: int = 0,
) -> EventScatterResult:
    """F frames' events -> F packed disparity maps + F inlier counts, in
    one launch; frame f equals ``event_disparity_scatter`` of frame f.

    ``batch``: an ``EventBatch`` with a leading frame axis (each lane field
    (F, capacity), ``EventBatch.stack_structured``); ``t_bin``: its (F,
    capacity) int32 time bins; ``priority``: (F, capacity) int32, each
    value below ``MAX_CAPACITY`` (None: the lane index within its frame
    plus ``index_offset``, as in ``event_disparity_scatter``: the F
    frames' lanes of one event shard).  Returns (F, out_h, out_w) maps and
    (F,) counts.
    """
    f, cap = _group_shape("event_disparity_scatter_group", batch.x)
    _check_offset("event_disparity_scatter_group", index_offset, cap)
    dev = batch.x.device
    if dev.type == "cpu":
        return event_disparity_scatter_group_plain(
            batch, t_bin, tables, camera_view=camera_view, window=window,
            out_shape=out_shape, priority=priority, index_offset=index_offset,
        )
    if dev.type != "cuda":
        raise ValueError(f"event_disparity_scatter_group: unsupported device {dev}")
    checked = [("x", batch.x, torch.int32), ("y", batch.y, torch.int32),
               ("t_bin", t_bin, torch.int32), ("valid", batch.valid, torch.bool)]
    if priority is not None:
        checked.append(("priority", priority, torch.int32))
    for name, a, dtype in checked:
        if (a.device != dev or a.dtype != dtype or not a.is_contiguous()
                or a.shape != (f, cap)):
            raise ValueError(
                f"event_disparity_scatter_group: {name} must be a contiguous ({f}, {cap}) "
                f"{dtype} tensor on {dev}, got {tuple(a.shape)} {a.dtype} on {a.device}")
    _check_tables("event_disparity_scatter_group", tables, dev)
    packed, counts = _outputs(out_shape, dev, frames=f)
    cam_h, cam_w = tables.cam_map_packed.shape
    xmap_h, xmap_w = tables.x_map.shape
    (oy, ox), (out_h, out_w) = window, out_shape
    _build.launch(
        dev, "event_disparity_scatter_group", "event_disparity_scatter_group",
        batch.x.data_ptr(), batch.y.data_ptr(), t_bin.data_ptr(), batch.valid.data_ptr(),
        None if priority is None else priority.data_ptr(), f, cap, index_offset,
        tables.cam_map_packed.data_ptr(), cam_h, cam_w,
        tables.x_map.data_ptr(), xmap_h, xmap_w,
        int(camera_view), oy, ox, out_h, out_w,
        packed.data_ptr(), counts.data_ptr(),
    )
    return EventScatterResult(packed, counts)


def event_disparity_scatter_staged_group_plain(
    staged: CompactStagedGroup,
    layout: CompactLayout,
    tables,
    *,
    camera_view: bool,
    window: tuple[int, int],
    out_shape: tuple[int, int],
) -> EventScatterResult:
    """Plain PyTorch version of ``event_disparity_scatter_staged_group``
    (any device): the one-frame staged plain version on each row, with its
    host count, stacked."""
    _group_shape("event_disparity_scatter_staged_group", staged.word)
    return _stack([
        event_disparity_scatter_staged_plain(
            row, n, layout, tables, camera_view=camera_view, window=window,
            out_shape=out_shape,
        )
        for row, n in zip(staged.word, staged.host_counts)
    ])


def event_disparity_scatter_staged_group(
    staged: CompactStagedGroup,
    layout: CompactLayout,
    tables,
    *,
    camera_view: bool,
    window: tuple[int, int],
    out_shape: tuple[int, int],
) -> EventScatterResult:
    """F frames' 1-word staged rows (``io.prefetch.stage_compact_group``)
    -> F packed disparity maps + F inlier counts, in one launch; frame f
    equals ``event_disparity_scatter_staged`` of row f and its count.  The
    kernel reads the counts from the group's device buffer; a row's lanes
    at or past its count are not read."""
    f, cap = _group_shape("event_disparity_scatter_staged_group", staged.word)
    if len(staged.host_counts) != f or not all(0 <= n <= cap for n in staged.host_counts):
        raise ValueError(f"event_disparity_scatter_staged_group: counts {staged.host_counts} "
                         f"for {f} rows of {cap}")
    dev = staged.word.device
    if dev.type == "cpu":
        return event_disparity_scatter_staged_group_plain(
            staged, layout, tables, camera_view=camera_view, window=window,
            out_shape=out_shape,
        )
    if dev.type != "cuda":
        raise ValueError(f"event_disparity_scatter_staged_group: unsupported device {dev}")
    for name, a, shape in (("word", staged.word, (f, cap)), ("counts", staged.counts, (f,))):
        if (a.device != dev or a.dtype != torch.int32 or not a.is_contiguous()
                or a.shape != shape):
            raise ValueError(
                f"event_disparity_scatter_staged_group: {name} must be a contiguous {shape} "
                f"int32 tensor on {dev}, got {tuple(a.shape)} {a.dtype} on {a.device}")
    bits = (layout.bits_x, layout.bits_y, layout.bits_t)
    if min(bits) < 1 or sum(bits) > 32:
        raise ValueError(f"event_disparity_scatter_staged_group: layout widths {bits}")
    _check_tables("event_disparity_scatter_staged_group", tables, dev)
    packed, counts = _outputs(out_shape, dev, frames=f)
    cam_h, cam_w = tables.cam_map_packed.shape
    xmap_h, xmap_w = tables.x_map.shape
    (oy, ox), (out_h, out_w) = window, out_shape
    _build.launch(
        dev, "event_disparity_scatter_group", "event_disparity_scatter_staged_group",
        staged.word.data_ptr(), staged.counts.data_ptr(), f, cap, *bits,
        tables.cam_map_packed.data_ptr(), cam_h, cam_w,
        tables.x_map.data_ptr(), xmap_h, xmap_w,
        int(camera_view), oy, ox, out_h, out_w,
        packed.data_ptr(), counts.data_ptr(),
    )
    return EventScatterResult(packed, counts)
