"""The per-frame depth program: one projector frame of events -> colorized
depth map.

Port of ``xmaps_tpu.ops.frame_pipeline.depth_frame`` (the reference's
process_ev_frame, depth_reprojection_pipe.py:121-167, minus display).  Both
render perspectives are supported:

- projector view (default): scatter into a crop of the rectified frame,
  dilate, remap to projector resolution (depth_reprojection_pipe.py:153-162);
- camera view: scatter at raw event coordinates
  (cam_proj_calibration.py:312-317).

On CUDA a frame is the time binning (a few PyTorch ops, skipped when the
host staged the time bins) and two kernels:
``event_disparity_scatter`` then ``tail_projector`` or ``colorize_camera``.
With a dedup frame filter (``cfg.frame_filter``, ``ops.filters``) the
events are first rectified (a gather of the camera LUT) and filtered; the
time binning then runs on the filtered batch and kernel 1 takes the
filter's scatter priority.  On CPU the same calls run the kernels' plain
versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from xmaps_tpu_torch.config import PipelineConfig
from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter
from xmaps_tpu_torch.ops.cuda_tail import (
    CamTailPlan,
    TailPlan,
    colorize_camera,
    tail_projector,
)
from xmaps_tpu_torch.ops.disparity import rectify_events, scale_time
from xmaps_tpu_torch.ops.event_batch import EventBatch
from xmaps_tpu_torch.ops.filters import FilteredBatch, apply_frame_filter
from xmaps_tpu_torch.ops.image_tail import turbo_packed_lut

__all__ = ["DeviceTables", "FrameResult", "depth_frame", "filter_events"]


class DeviceTables(NamedTuple):
    """Per-session lookup tables, resident on the engine's device."""

    cam_mapx_i16: torch.Tensor  # (H_cam, W_cam) int16: cam px -> rect x
    cam_mapy_i16: torch.Tensor  # (H_cam, W_cam) int16: cam px -> rect y
    cam_map_packed: torch.Tensor  # (H_cam, W_cam) int32: mapy<<16 | mapx
    x_map: torch.Tensor  # (H_rect, W_time) int16
    proj_mapx_i16: torch.Tensor  # (H_proj, W_proj) int16: proj px -> rect x
    proj_mapy_i16: torch.Tensor  # (H_proj, W_proj) int16: proj px -> rect y
    p03: torch.Tensor  # 0-dim float32: P2[0, 3] (baseline * focal)
    turbo_lut: torch.Tensor  # (256,) int32 packed-BGR TURBO, entry 0 white

    @staticmethod
    def from_numpy(
        cam_mapx_i16: np.ndarray,
        cam_mapy_i16: np.ndarray,
        x_map: np.ndarray,
        proj_mapx_i16: np.ndarray,
        proj_mapy_i16: np.ndarray,
        p03,
        device,
    ) -> "DeviceTables":
        """Upload host tables (e.g. ``np.asarray`` of each field of the JAX
        package's DeviceTables); ``cam_map_packed`` and ``turbo_lut`` are
        derived."""
        mapx = np.asarray(cam_mapx_i16, np.int16)
        mapy = np.asarray(cam_mapy_i16, np.int16)
        packed = (mapy.astype(np.int32) << 16) | (mapx.astype(np.int32) & 0xFFFF)

        def dev(a, dtype):
            # a writable contiguous copy: the inputs may be read-only views
            return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)

        return DeviceTables(
            cam_mapx_i16=dev(mapx, np.int16),
            cam_mapy_i16=dev(mapy, np.int16),
            cam_map_packed=dev(packed, np.int32),
            x_map=dev(x_map, np.int16),
            proj_mapx_i16=dev(proj_mapx_i16, np.int16),
            proj_mapy_i16=dev(proj_mapy_i16, np.int16),
            p03=dev(np.float32(p03), np.float32),
            turbo_lut=dev(turbo_packed_lut(), np.int32),
        )

    @staticmethod
    def from_maps(cam_proj_maps, x_map: np.ndarray, device) -> "DeviceTables":
        m = cam_proj_maps
        return DeviceTables.from_numpy(
            m.disp_cam_mapx_i16, m.disp_cam_mapy_i16, x_map,
            m.disp_proj_mapx_i16, m.disp_proj_mapy_i16, m.P2[0, 3], device,
        )

    def to(self, device) -> "DeviceTables":
        return DeviceTables(*(a.to(device) for a in self))


def filter_events(
    batch: EventBatch, tables: DeviceTables, cfg: PipelineConfig
) -> FilteredBatch:
    """``cfg.frame_filter`` applied to the batch (``ops.filters``), with the
    per-event rectified x that first_per_yt keys on (the other filters key
    on the raw pixel and get None)."""
    x_rect = None
    if cfg.frame_filter == "first_per_yt":
        x_rect, _ = rectify_events(batch.x, batch.y, tables.cam_mapx_i16, tables.cam_mapy_i16)
    return apply_frame_filter(
        batch,
        x_rect,
        name=cfg.frame_filter,
        camera_width=cfg.camera_width,
        camera_height=cfg.camera_height,
        rect_width=cfg.rect_width,
    )


class FrameResult(NamedTuple):
    #: (H_out, W_out, 3) uint8 colorized depth, or with display_packed one
    #: (H_out, W_out) int32 packed-BGR plane (B | G<<8 | R<<16)
    frame_bgr: torch.Tensor
    depth: Optional[torch.Tensor]  # (H_out, W_out) float32 (0 = undefined)
    disp_map: Optional[torch.Tensor]  # view-dependent disparity map, float32
    num_inliers: torch.Tensor  # 0-dim int32


def depth_frame(
    batch: EventBatch,
    tables: DeviceTables,
    cfg: PipelineConfig,
    plan: Union[TailPlan, CamTailPlan],
    *,
    t_scaled: Optional[torch.Tensor] = None,
    display_only: bool = False,
    display_packed: bool = False,
) -> FrameResult:
    """One projector frame of events -> colorized depth map.

    ``plan``: the engine's ``TailPlan`` (projector view) or
    ``CamTailPlan`` (camera view, ``cfg.camera_perspective``).
    ``t_scaled`` (int32 X-map time bins, computed exactly on the host by
    ``io.prefetch`` compact staging) skips the time binning; only valid
    with ``frame_filter == "none"`` (filters change the frame's time
    bounds, so bins must be computed after filtering).
    ``display_only`` returns depth and disp_map as None (the kernels skip
    the two f32 stores); ``display_packed`` (requires display_only) returns
    frame_bgr as one packed-BGR int32 plane.
    """
    if display_packed and not display_only:
        raise ValueError(
            "display_packed emits only the packed colorized plane; it "
            "requires display_only"
        )
    if t_scaled is not None and cfg.frame_filter != "none":
        raise ValueError(
            "precomputed t_scaled requires frame_filter == 'none' "
            "(filters change the frame's time bounds)"
        )
    priority = None
    if cfg.frame_filter != "none":
        batch, priority = filter_events(batch, tables, cfg)
    t_bin = (
        scale_time(batch.t, batch.valid, cfg.t_px_scale)
        if t_scaled is None
        else t_scaled
    )
    if cfg.camera_perspective:
        assert isinstance(plan, CamTailPlan), plan
        window, out_shape = (0, 0), (cfg.camera_height, cfg.camera_width)
    else:
        assert isinstance(plan, TailPlan), plan
        window, out_shape = (plan.crop_row0, plan.crop_col0), (plan.H, plan.W)
    ev = event_disparity_scatter(
        batch, t_bin, tables,
        camera_view=cfg.camera_perspective, window=window, out_shape=out_shape,
        priority=priority,
    )
    tail = colorize_camera if cfg.camera_perspective else tail_projector
    frame, depth, disp_map = tail(
        ev.packed_map, tables, plan,
        emit_aux=not display_only, packed_bgr=display_packed,
    )
    return FrameResult(
        frame_bgr=frame, depth=depth, disp_map=disp_map,
        num_inliers=ev.num_inliers,
    )
