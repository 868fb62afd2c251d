"""Kernel 1 wrapper: per-event rectify + X-map gather + packed scatter.

``event_disparity_scatter`` turns one frame's events and their X-map time
bins into the packed int32 disparity map (crop of the rectified frame for
the projector view, the camera frame for the camera view) and the inlier
count.  On CUDA tensors it launches ``csrc/events.cu`` (replacing the TPU
kernels ``rectify_and_lookup`` / ``rectify_and_lookup_hbm``); on CPU tensors
it runs the plain version, ``compute_event_disparity`` +
``scatter_disp_packed``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from xmaps_tpu_torch.ops import _build
from xmaps_tpu_torch.ops.disparity import compute_event_disparity
from xmaps_tpu_torch.ops.event_batch import EventBatch
from xmaps_tpu_torch.ops.scatter import MAX_CAPACITY, scatter_disp_packed

__all__ = [
    "EventScatterResult",
    "event_disparity_scatter",
    "event_disparity_scatter_plain",
]


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
        ys - oy, xs - ox, res.disp, res.inlier, height=out_h, width=out_w
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
) -> EventScatterResult:
    """One frame's events -> packed disparity map + inlier count.

    ``t_bin``: (N,) int32 X-map time bins (``ops.disparity.scale_time``).
    ``tables``: ``ops.frame_pipeline.DeviceTables`` on the batch's device.
    ``window``: (oy, ox) origin of the map in target coordinates;
    ``out_shape``: (out_h, out_w) of the map; targets outside are dropped.
    ``want_lanes`` also returns the per-lane (x_rect, y_rect, x_proj).
    """
    dev = batch.x.device
    if dev.type == "cpu":
        return event_disparity_scatter_plain(
            batch, t_bin, tables, camera_view=camera_view, window=window,
            out_shape=out_shape, want_lanes=want_lanes,
        )
    if dev.type != "cuda":
        raise ValueError(f"event_disparity_scatter: unsupported device {dev}")
    n = batch.x.shape[0]
    if n > MAX_CAPACITY:
        raise ValueError(
            f"event_disparity_scatter: capacity {n} overflows the uint32 packing "
            f"(at most {MAX_CAPACITY})"
        )
    for name, a, dtype in (
        ("x", batch.x, torch.int32),
        ("y", batch.y, torch.int32),
        ("t_bin", t_bin, torch.int32),
        ("valid", batch.valid, torch.bool),
        ("cam_map_packed", tables.cam_map_packed, torch.int32),
        ("x_map", tables.x_map, torch.int16),
    ):
        if a.device != dev or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(
                f"event_disparity_scatter: {name} must be a contiguous {dtype} "
                f"tensor on {dev}, got {a.dtype} on {a.device}"
            )
    for name, a in (("y", batch.y), ("t_bin", t_bin), ("valid", batch.valid)):
        if a.shape != (n,):
            raise ValueError(f"event_disparity_scatter: {name} shape {tuple(a.shape)} != ({n},)")
    lib = _build.load()
    out_h, out_w = out_shape
    packed = torch.zeros((out_h, out_w), dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    lanes = None
    lane_ptrs = (None, None, None)
    if want_lanes:
        lanes = tuple(torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3))
        lane_ptrs = tuple(a.data_ptr() for a in lanes)
    cam_h, cam_w = tables.cam_map_packed.shape
    xmap_h, xmap_w = tables.x_map.shape
    oy, ox = window
    err = lib.event_disparity_scatter(
        batch.x.data_ptr(), batch.y.data_ptr(), t_bin.data_ptr(),
        batch.valid.data_ptr(), n,
        tables.cam_map_packed.data_ptr(), cam_h, cam_w,
        tables.x_map.data_ptr(), xmap_h, xmap_w,
        int(camera_view), oy, ox, out_h, out_w,
        packed.data_ptr(), count.data_ptr(), *lane_ptrs,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("event_disparity_scatter", err)
    _build.LAUNCHES["event_disparity_scatter"] += 1
    return EventScatterResult(packed, count, lanes)
