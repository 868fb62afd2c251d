"""XMapsDepthEngine: the event->depth engine bound to one calibration.

Port of ``xmaps_tpu.models.depth_pipeline.XMapsDepthEngine``: the one-time
init (calibration maps, rectified time map, X-map build, tail plan) and the
per-frame call.  The engine lives on one explicit ``device``; there is no
auto-pick and no fallback.  On ``cuda`` the kernels are built (or loaded)
at construction, so a missing ``nvcc`` fails there and not mid-stream.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from xmaps_tpu_torch.calib.maps import CalibrationParams, CamProjMaps
from xmaps_tpu_torch.config import PipelineConfig, RuntimeParams
from xmaps_tpu_torch.io.prefetch import (
    CompactLayout,
    CompactStagedBatch,
    unpack_staged,
    unpack_staged_compact,
)
from xmaps_tpu_torch.ops.cuda_tail import CamTailPlan, TailPlan, build_tail_plan
from xmaps_tpu_torch.ops.event_batch import EventBatch
from xmaps_tpu_torch.ops.filters import check_filter_name
from xmaps_tpu_torch.ops.frame_pipeline import DeviceTables, FrameResult, depth_frame
from xmaps_tpu_torch.ops.scatter import MAX_CAPACITY
from xmaps_tpu_torch.ops.xmap import build_x_map, xmap_cache_key

__all__ = ["XMapsDepthEngine", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device: "cpu", or "cuda" with a card present
    (the kernels are built or loaded here); anything else raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly to run the plain "
                "PyTorch versions"
            )
        from xmaps_tpu_torch.ops import _build

        _build.load()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


@dataclass
class XMapsDepthEngine:
    """End-to-end depth pipeline bound to one calibration and one device.

    Build with :meth:`from_calibration`; ``process_frame`` turns one
    frame's events into a colorized depth map.
    """

    cfg: PipelineConfig
    maps: CamProjMaps
    tables: DeviceTables
    x_map_np: np.ndarray
    time_map_rect: np.ndarray
    plan: Union[TailPlan, CamTailPlan]
    device: torch.device

    # -- construction --------------------------------------------------

    @staticmethod
    def from_calibration(
        calib: CalibrationParams,
        *,
        device,
        event_capacity: int = 65536,
        z_near: float = 0.1,
        z_far: float = 1.0,
        camera_perspective: bool = False,
        scan_upwards: bool = True,
        # False = the reference's EXECUTED border behavior (see
        # calib.maps.CamProjMaps.build_rectified_time_map)
        border_replicate: bool = False,
        zero_undistort_proj_map: bool = False,
        projector_time_map_path: Optional[str] = None,
        xmap_cache_dir: Optional[str] = None,
    ) -> "XMapsDepthEngine":
        if event_capacity > MAX_CAPACITY:
            raise ValueError(
                f"event_capacity {event_capacity} overflows the uint32 PACK "
                f"packing (at most {MAX_CAPACITY})"
            )
        dev = resolve_device(device)
        cfg = PipelineConfig(
            camera_width=calib.camera_width,
            camera_height=calib.camera_height,
            projector_width=calib.projector_width,
            projector_height=calib.projector_height,
            rect_width=calib.rect_image_width,
            rect_height=calib.rect_image_height,
            event_capacity=event_capacity,
            z_near=z_near,
            z_far=z_far,
            camera_perspective=camera_perspective,
        )
        maps = CamProjMaps.build_cached(
            calib,
            zero_undistort_proj_map=zero_undistort_proj_map,
            cache_dir=xmap_cache_dir,
        )
        if projector_time_map_path is not None:
            # precalibrated rectified time map (reference proj_time_map.py:47-49)
            time_map_rect = np.load(projector_time_map_path)
        else:
            time_map_rect = maps.build_rectified_time_map(
                scan_upwards=scan_upwards, border_replicate=border_replicate
            )
        x_map_np = XMapsDepthEngine._build_or_load_xmap(
            time_map_rect, cfg, xmap_cache_dir, dev
        )
        tables = DeviceTables.from_maps(maps, x_map_np, dev)
        p03 = float(maps.P2[0, 3])
        if camera_perspective:
            plan = CamTailPlan(
                H=calib.camera_height, W=calib.camera_width,
                p03=p03, z_near=z_near, z_far=z_far,
            )
        else:
            plan = build_tail_plan(
                maps.disp_proj_mapx_i16,
                maps.disp_proj_mapy_i16,
                calib.rect_image_height,
                calib.rect_image_width,
                p03=p03,
                z_near=z_near,
                z_far=z_far,
            )
        return XMapsDepthEngine(
            cfg=cfg,
            maps=maps,
            tables=tables,
            x_map_np=x_map_np,
            time_map_rect=time_map_rect,
            plan=plan,
            device=dev,
        )

    @staticmethod
    def from_runtime_params(
        params: RuntimeParams, *, device, **kw
    ) -> "XMapsDepthEngine":
        """The engine of the replay app's RuntimeParams (calibration YAML
        in the X-maps dialect).  CLI sessions reuse the maps and the
        X-map across runs through the disk cache (default
        ``~/.cache/xmaps_tpu_torch``; the key hashes the time map and the
        geometry)."""
        calib = CalibrationParams.from_yaml(
            params.calib,
            params.camera_width,
            params.camera_height,
            params.projector_width,
            params.projector_height,
        )
        kw.setdefault(
            "xmap_cache_dir", os.path.expanduser("~/.cache/xmaps_tpu_torch")
        )
        return XMapsDepthEngine.from_calibration(
            calib,
            device=device,
            z_near=params.z_near,
            z_far=params.z_far,
            camera_perspective=params.camera_perspective,
            projector_time_map_path=params.projector_time_map,
            **kw,
        )

    @staticmethod
    def _build_or_load_xmap(
        time_map_rect: np.ndarray,
        cfg: PipelineConfig,
        cache_dir: Optional[str],
        device: torch.device,
    ) -> np.ndarray:
        """Build the X-map on ``device`` (the heavy init step), with an
        optional disk cache keyed as the JAX engine's."""
        key = xmap_cache_key(
            time_map_rect, cfg.x_map_width, cfg.t_px_scale, cfg.projector_width
        )
        cache_path = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            cache_path = os.path.join(cache_dir, f"xmap_{key}.npy")
            if os.path.exists(cache_path):
                return np.load(cache_path)
        x_map, _ = build_x_map(
            torch.from_numpy(np.ascontiguousarray(time_map_rect)).to(device),
            x_map_width=cfg.x_map_width,
            t_px_scale=cfg.t_px_scale,
            num_scanlines=cfg.projector_width,
        )
        x_map = x_map.cpu().numpy()
        if cache_path:
            np.save(cache_path, x_map)
        return x_map

    def to(self, device) -> "XMapsDepthEngine":
        """The same engine (same tables) on another device."""
        dev = resolve_device(device)
        return XMapsDepthEngine(
            cfg=self.cfg,
            maps=self.maps,
            tables=self.tables.to(dev),
            x_map_np=self.x_map_np,
            time_map_rect=self.time_map_rect,
            plan=self.plan,
            device=dev,
        )

    # -- per-frame API ---------------------------------------------------

    def make_batch(self, events: np.ndarray) -> EventBatch:
        return EventBatch.from_structured(
            events, self.cfg.event_capacity, device=self.device
        )

    def process_frame(
        self,
        events: np.ndarray,
        *,
        display_only: bool = False,
        display_packed: bool = False,
    ) -> FrameResult:
        """events: structured array with x/y/t/p (one projector frame)."""
        return depth_frame(
            self.make_batch(events),
            self.tables,
            self.cfg,
            self.plan,
            display_only=display_only,
            display_packed=display_packed,
        )

    def process_batch_device(self, batch: EventBatch) -> FrameResult:
        """Run the frame program on a batch already on the engine's device
        (e.g. ``EventBatch.from_arrays`` of float-time scan events, as the
        offline eval builds them)."""
        return depth_frame(batch, self.tables, self.cfg, self.plan)

    @property
    def compact_layout(self) -> Optional[CompactLayout]:
        """The 1-word staging layout, or None where the camera and time
        axis do not fit 32 bits."""
        return CompactLayout.for_pipeline(self.cfg)

    def process_staged(self, staged) -> FrameResult:
        """Run the frame on a packed ``io.prefetch`` batch (the streaming
        hot path; validity implied by the count), display-only with the
        packed-BGR plane, as the JAX engine's streaming program.  Accepts
        a StagedBatch (2 words/event) or, when the pipeline is
        unfiltered, a CompactStagedBatch (1 word/event with host-binned
        time)."""
        kw = dict(display_only=True, display_packed=True)
        if isinstance(staged, CompactStagedBatch):
            layout = self.compact_layout
            if layout is None or self.cfg.frame_filter != "none":
                raise ValueError(
                    "compact staging requires frame_filter == 'none' and "
                    "a 32-bit-fit CompactLayout"
                )
            batch, ts = unpack_staged_compact(staged, layout)
            return depth_frame(batch, self.tables, self.cfg, self.plan, t_scaled=ts, **kw)
        return depth_frame(unpack_staged(staged), self.tables, self.cfg, self.plan, **kw)

    def process_frames(self, frames: list, **kw) -> list:
        """Run many independent frames, one after another (one
        ``process_frame`` each; keyword arguments are passed on)."""
        return [self.process_frame(ev, **kw) for ev in frames]

    def set_frame_filter(self, name: str):
        """Select the frame dedup filter, one of ``ops.filters.FILTER_NAMES``
        (the E key's cycle); an unknown name raises ValueError and leaves
        the filter as it was.  A filtered pipeline stages 2 words an event
        (raw timestamps and polarity), see ``process_staged``."""
        check_filter_name(name)
        self.cfg = self.cfg.replace(frame_filter=name)
