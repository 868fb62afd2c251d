"""The per-frame depth program: one projector frame of events -> colorized
depth map.

Port of ``xmaps_tpu.ops.frame_pipeline.depth_frame`` (the reference's
process_ev_frame, depth_reprojection_pipe.py:121-167, minus display).  Both
render perspectives are supported:

- projector view (default): scatter into a crop of the rectified frame,
  dilate, remap to projector resolution (depth_reprojection_pipe.py:153-162);
- camera view: scatter at raw event coordinates
  (cam_proj_calibration.py:312-317).

On CUDA a frame is the time binning (a few PyTorch ops) and two kernels:
``event_disparity_scatter`` then ``tail_projector`` or ``colorize_camera``.
``staged_depth_frame`` runs the 1-word staged batch of the streaming path
(the time bins binned on the host) through the kernel's staged entry, which
decodes the words itself: the two kernels and nothing else.
``ring_depth_frame`` runs a frame that is already on the card as packet
rows of the ring (``io.prefetch.PacketRing`` with a ``RingLayout``,
unfiltered) through the kernel's ring entry, which reads the rows, decodes
the words and bins time from the frame's host time bounds: again the two
kernels and nothing else.
With a dedup frame filter (``cfg.frame_filter``, ``ops.filters``) the
events are first filtered (on CUDA kernel F ``frame_dedup_filter``, which
reads first_per_yt's rectified x from the camera LUT itself); the time
binning then runs on the filtered batch and kernel 1 takes the filter's
scatter priority.
``group_depth_frames`` runs F independent frames as one program (the
counterpart of the JAX engine's ``process_frames`` group and of
``bench.py``'s ``run_group``): kernel 1's group entry once over the F
frames, then kernel 2's or kernel 3's group entry once over the F maps.
On CPU the same calls run the kernels' plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from xmaps_tpu_torch.config import PipelineConfig
from xmaps_tpu_torch.ops.cuda_events import (
    event_disparity_scatter,
    event_disparity_scatter_group,
    event_disparity_scatter_ring,
    event_disparity_scatter_staged,
    event_disparity_scatter_staged_group,
)
from xmaps_tpu_torch.ops.cuda_tail import (
    CamTailPlan,
    TailPlan,
    colorize_camera,
    colorize_camera_group,
    tail_projector,
    tail_projector_group,
)
from xmaps_tpu_torch.ops.disparity import rectify_events, scale_time
from xmaps_tpu_torch.ops.event_batch import EventBatch
from xmaps_tpu_torch.ops.filters import (
    FilteredBatch,
    apply_frame_filter,
    apply_frame_filter_group,
)
from xmaps_tpu_torch.ops.image_tail import turbo_packed_lut
from xmaps_tpu_torch.ops.staged import (
    CompactLayout,
    CompactStagedBatch,
    CompactStagedGroup,
    RingLayout,
)
from xmaps_tpu_torch.utils.stats import span

__all__ = [
    "DeviceTables",
    "FrameResult",
    "depth_frame",
    "filter_events",
    "group_depth_frames",
    "group_tail",
    "ring_depth_frame",
    "scatter_view",
    "staged_depth_frame",
]


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
    """``cfg.frame_filter`` applied to the batch, one frame or a stacked
    group (``ops.filters.apply_frame_filter`` / ``apply_frame_filter_group``:
    on CUDA one launch of kernel F either way).  first_per_yt keys on the
    per-event rectified x: on the CPU ``rectify_events`` gathers it, on
    CUDA kernel F reads it from the camera LUT itself; the other filters
    key on the raw pixel."""
    x_rect, lut = None, None
    if cfg.frame_filter == "first_per_yt":
        if batch.x.device.type == "cpu":
            x_rect, _ = rectify_events(batch.x, batch.y, tables.cam_mapx_i16,
                                       tables.cam_mapy_i16)
        else:
            lut = tables.cam_map_packed
    apply = apply_frame_filter_group if batch.x.dim() == 2 else apply_frame_filter
    return apply(
        batch,
        x_rect,
        name=cfg.frame_filter,
        camera_width=cfg.camera_width,
        camera_height=cfg.camera_height,
        rect_width=cfg.rect_width,
        cam_lut=lut,
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
    display_only: bool = False,
    display_packed: bool = False,
) -> FrameResult:
    """One projector frame of events -> colorized depth map.

    ``plan``: the engine's ``TailPlan`` (projector view) or
    ``CamTailPlan`` (camera view, ``cfg.camera_perspective``).
    ``display_only`` returns depth and disp_map as None (the kernels skip
    the two f32 stores); ``display_packed`` (requires display_only) returns
    frame_bgr as one packed-BGR int32 plane.
    """
    _check_display(display_only, display_packed)
    priority = None
    if cfg.frame_filter != "none":
        batch, priority = filter_events(batch, tables, cfg)
    t_bin = scale_time(batch.t, batch.valid, cfg.t_px_scale)
    ev = event_disparity_scatter(
        batch, t_bin, tables, **scatter_view(cfg, plan), priority=priority,
    )
    return _tail(ev, tables, cfg, plan, display_only, display_packed)


def staged_depth_frame(
    staged: CompactStagedBatch,
    layout: CompactLayout,
    tables: DeviceTables,
    cfg: PipelineConfig,
    plan: Union[TailPlan, CamTailPlan],
    *,
    display_only: bool = False,
    display_packed: bool = False,
) -> FrameResult:
    """``depth_frame`` of a 1-word staged batch (``io.prefetch``
    ``stage_compact``: host time bins, validity implied by the count),
    unfiltered: kernel 1's staged entry, then the tail."""
    if layout is None or cfg.frame_filter != "none":
        raise ValueError("compact staging requires frame_filter == 'none' and "
                         "a 32-bit-fit CompactLayout")
    ev = event_disparity_scatter_staged(
        staged.word, staged.count, layout, tables, **scatter_view(cfg, plan),
    )
    return _tail(ev, tables, cfg, plan, display_only, display_packed)


def ring_depth_frame(
    rows,
    meta: np.ndarray,
    t_bounds: tuple[int, int],
    layout: RingLayout,
    tables: DeviceTables,
    cfg: PipelineConfig,
    plan: Union[TailPlan, CamTailPlan],
    *,
    display_only: bool = False,
    display_packed: bool = False,
) -> FrameResult:
    """``depth_frame`` of a frame held by k packet rows of the 1-word ring
    (``rows``: the packets' device rows; ``meta``: the host (3, k)
    placement of ``PacketRing.frame_meta``; ``t_bounds``: the frame's host
    time bounds, ``io.prefetch.ring_time_bounds``), unfiltered: kernel 1's
    ring entry, then the tail.  The counterpart of the JAX engine's
    ``ring_frame_compact``."""
    if cfg.frame_filter != "none":
        raise ValueError("kernel 1's ring entry requires frame_filter == 'none'")
    count = min(int(meta[1].sum()), cfg.event_capacity)
    ev = event_disparity_scatter_ring(
        rows, meta, count, t_bounds, layout, tables, t_px_scale=cfg.t_px_scale,
        **scatter_view(cfg, plan),
    )
    return _tail(ev, tables, cfg, plan, display_only, display_packed)


def group_depth_frames(
    group: Union[EventBatch, CompactStagedGroup],
    tables: DeviceTables,
    cfg: PipelineConfig,
    plan: Union[TailPlan, CamTailPlan],
    *,
    layout: Optional[CompactLayout] = None,
    display_only: bool = False,
    display_packed: bool = False,
) -> FrameResult:
    """F independent frames -> one ``FrameResult`` whose fields carry a
    leading frame axis (``num_inliers`` (F,)); frame f equals
    ``depth_frame`` of frame f bit for bit.

    ``group``: the F 1-word staged rows of ``io.prefetch.stage_compact_group``
    (with their ``layout``; unfiltered), or an ``EventBatch`` with a leading
    frame axis (``EventBatch.stack_structured``; integer or float time,
    any filter).  With a dedup filter the stacked batch is first filtered
    (``filter_events``: kernel F's group entry, one launch for the F
    frames), then binned as one (F, capacity) tensor.  Then kernel 1's
    group entry (one launch for the F frames) and the view's tail group
    entry (one call)."""
    with span("engine.group"):
        _check_display(display_only, display_packed)
        view = scatter_view(cfg, plan)
        if isinstance(group, CompactStagedGroup):
            if layout is None or cfg.frame_filter != "none":
                raise ValueError("1-word staged rows need their layout and frame_filter == 'none'")
            ev = event_disparity_scatter_staged_group(group, layout, tables, **view)
        else:
            priority = None
            if cfg.frame_filter != "none":
                group, priority = filter_events(group, tables, cfg)
            t_bin = scale_time(group.t, group.valid, cfg.t_px_scale)
            ev = event_disparity_scatter_group(group, t_bin, tables, **view, priority=priority)
        return group_tail(ev, tables, cfg, plan, display_only=display_only,
                          display_packed=display_packed)


def group_tail(
    ev,
    tables: DeviceTables,
    cfg: PipelineConfig,
    plan: Union[TailPlan, CamTailPlan],
    *,
    display_only: bool = False,
    display_packed: bool = False,
) -> FrameResult:
    """The view's tail group entry (one call) on kernel 1's F maps ``ev``
    (an ``EventScatterResult`` with a leading frame axis): the F frames'
    ``FrameResult``."""
    _check_display(display_only, display_packed)
    tail = colorize_camera_group if cfg.camera_perspective else tail_projector_group
    frame, depth, disp_map = tail(
        ev.packed_map, tables, plan,
        emit_aux=not display_only, packed_bgr=display_packed,
    )
    return FrameResult(
        frame_bgr=frame, depth=depth, disp_map=disp_map, num_inliers=ev.num_inliers,
    )


def _check_display(display_only: bool, display_packed: bool) -> None:
    if display_packed and not display_only:
        raise ValueError(
            "display_packed emits only the packed colorized plane; it "
            "requires display_only"
        )


def scatter_view(cfg: PipelineConfig, plan) -> dict:
    """Kernel 1's view arguments: the camera frame, or the tail's crop of
    the rectified frame."""
    if cfg.camera_perspective:
        assert isinstance(plan, CamTailPlan), plan
        return dict(camera_view=True, window=(0, 0),
                    out_shape=(cfg.camera_height, cfg.camera_width))
    assert isinstance(plan, TailPlan), plan
    return dict(camera_view=False, window=(plan.crop_row0, plan.crop_col0),
                out_shape=(plan.H, plan.W))


def _tail(ev, tables, cfg, plan, display_only, display_packed) -> FrameResult:
    """The view's tail kernel on kernel 1's packed map."""
    tail = colorize_camera if cfg.camera_perspective else tail_projector
    frame, depth, disp_map = tail(
        ev.packed_map, tables, plan,
        emit_aux=not display_only, packed_bgr=display_packed,
    )
    return FrameResult(
        frame_bgr=frame, depth=depth, disp_map=disp_map,
        num_inliers=ev.num_inliers,
    )
