"""XMapsDepthEngine: the event->depth engine bound to one calibration.

Port of ``xmaps_tpu.models.depth_pipeline.XMapsDepthEngine``: the one-time
init (calibration maps, rectified time map, X-map build, tail plan) and the
per-frame call.  The engine lives on one explicit ``device``; there is no
auto-pick and no fallback.  On ``cuda`` the kernels are built (or loaded)
at construction, so a missing ``nvcc`` fails there and not mid-stream.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from xmaps_tpu_torch.calib.maps import CalibrationParams, CamProjMaps
from xmaps_tpu_torch.config import PipelineConfig, RuntimeParams
from xmaps_tpu_torch.io import stage_pack
from xmaps_tpu_torch.io.prefetch import scan_group, stage_compact_group
from xmaps_tpu_torch.ops.cuda_tail import (
    CamTailPlan,
    TailPlan,
    build_tail_plan,
    with_colorize_table,
)
from xmaps_tpu_torch.ops.event_batch import EventBatch
from xmaps_tpu_torch.ops.filters import check_filter_name
from xmaps_tpu_torch.ops.frame_pipeline import (
    DeviceTables,
    FrameResult,
    depth_frame,
    group_depth_frames,
    ring_depth_frame,
    staged_depth_frame,
)
from xmaps_tpu_torch.ops.scatter import MAX_CAPACITY
from xmaps_tpu_torch.ops.staged import (
    RING_SLOTS_PER_FRAME,
    CompactLayout,
    CompactStagedBatch,
    CompactStagedGroup,
    RingLayout,
    assemble_ring_frame,
    assemble_ring_frame_compact,
    unpack_staged,
)
from xmaps_tpu_torch.ops.xmap import build_x_map, xmap_cache_key
from xmaps_tpu_torch.parallel.sharding import (
    make_group_sharded_pipeline,
    replicate,
    shard_staged_group,
    split_frames,
)
from xmaps_tpu_torch.utils.stats import span

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


def _time_kinds(frames: list) -> list:
    """The frames' indices grouped by timestamp kind (integer, then
    float), the empty kinds left out."""
    ints = [np.issubdtype(ev.dtype["t"].type, np.integer) for ev in frames]
    kinds = ([i for i, k in enumerate(ints) if k], [i for i, k in enumerate(ints) if not k])
    return [idx for idx in kinds if idx]


def _unstack(res: FrameResult) -> list:
    """The frames of a group's ``FrameResult`` (fields with a leading
    frame axis), as views."""
    fields = [[None] * len(res.num_inliers) if a is None else a.unbind(0) for a in res]
    return [FrameResult(*parts) for parts in zip(*fields)]


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
    #: {device: (tables, plan)} copies for ``process_frames_sharded``, one a
    #: distinct device (``parallel.sharding.replicate``)
    _replicas: dict = field(default_factory=dict, init=False, repr=False, compare=False)
    #: the sharded group pipelines, by (mesh, cfg)
    _sharded: dict = field(default_factory=dict, init=False, repr=False, compare=False)
    #: per-step wall-clock breakdown of the build, (label, seconds since the
    #: previous mark), for ``apps.profile_setup`` (``from_calibration``)
    setup_timings: list = field(default_factory=list, init=False, repr=False, compare=False)

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
        """The engine of ``calib`` on ``device``.  Each step of the build is
        timed into ``setup_timings`` (on ``cuda`` each mark waits for the
        card first); ``XMAPS_SETUP_TRACE=1`` prints every mark to stderr, as
        the JAX engine does."""
        if event_capacity > MAX_CAPACITY:
            raise ValueError(
                f"event_capacity {event_capacity} overflows the uint32 PACK "
                f"packing (at most {MAX_CAPACITY})"
            )
        trace = os.environ.get("XMAPS_SETUP_TRACE") == "1"
        t0 = time.perf_counter()
        timings: list = []
        prev = [t0]

        def mark(label):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings.append((label, now - prev[0]))
            prev[0] = now
            if trace:
                print(f"[setup +{now - t0:7.2f}s] {label}", file=sys.stderr, flush=True)

        # on cuda this builds (cold) or loads the kernel library and the
        # group staging's host library (g++), so no build lands in a timed
        # call; a CPU engine loads the latter at its first native staging
        dev = resolve_device(device)
        if dev.type == "cuda":
            stage_pack.load()
        mark("device resolved (kernel library built or loaded)")
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
        mark("CamProjMaps (host calibration math, disk-cached)")
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
        mark("X-map build/load")
        tables = DeviceTables.from_maps(maps, x_map_np, dev)
        mark("DeviceTables H2D")
        p03 = float(maps.P2[0, 3])
        if camera_perspective:
            plan = with_colorize_table(CamTailPlan(
                H=calib.camera_height, W=calib.camera_width,
                p03=p03, z_near=z_near, z_far=z_far,
            ), tables)
        else:
            plan = with_colorize_table(build_tail_plan(
                maps.disp_proj_mapx_i16,
                maps.disp_proj_mapy_i16,
                calib.rect_image_height,
                calib.rect_image_width,
                p03=p03,
                z_near=z_near,
                z_far=z_far,
            ), tables)
        mark("kernel plans built (tail plan, colorize table)")
        eng = XMapsDepthEngine(
            cfg=cfg,
            maps=maps,
            tables=tables,
            x_map_np=x_map_np,
            time_map_rect=time_map_rect,
            plan=plan,
            device=dev,
        )
        mark("engine assembled")
        eng.setup_timings = timings
        return eng

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
        """The same engine (same tables) on another device; the plan's
        colorize table is built there on CUDA, dropped on CPU."""
        dev = resolve_device(device)
        tables, plan = replicate(self.tables, self.plan, dev)
        eng = XMapsDepthEngine(
            cfg=self.cfg,
            maps=self.maps,
            tables=tables,
            x_map_np=self.x_map_np,
            time_map_rect=self.time_map_rect,
            plan=plan,
            device=dev,
        )
        eng.setup_timings = list(self.setup_timings)
        return eng

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

    @property
    def one_word_layout(self) -> Optional[CompactLayout]:
        """Whether a frame goes at one word an event: the layout it is
        staged at, or None for two words.  One word where the engine has a
        ``compact_layout`` and no dedup filter is set (a filter re-bins time
        after it drops events, so it needs each event's raw timestamp and
        polarity).  The pipe's segmented staging, ``process_staged``,
        ``process_ring`` and ``stage_group`` all ask this."""
        return self.compact_layout if self.cfg.frame_filter == "none" else None

    def process_staged(self, staged) -> FrameResult:
        """Run the frame on a packed ``io.prefetch`` batch (the streaming
        hot path; validity implied by the count), display-only with the
        packed-BGR plane, as the JAX engine's streaming program.  Accepts
        a StagedBatch (2 words/event) or, where ``one_word_layout`` is
        set, a CompactStagedBatch (1 word/event with host-binned time),
        which kernel 1 decodes itself: nothing runs on the card between
        the batch's copy and kernel 1."""
        kw = dict(display_only=True, display_packed=True)
        if isinstance(staged, CompactStagedBatch):
            return staged_depth_frame(staged, self.one_word_layout, self.tables, self.cfg,
                                      self.plan, **kw)
        return depth_frame(unpack_staged(staged), self.tables, self.cfg, self.plan, **kw)

    @property
    def ring_layout(self) -> Optional[RingLayout]:
        """The 1-word packet-ring layout, or None where the camera leaves
        fewer than 13 bits for the packet-relative time (2-word ring)."""
        return RingLayout.for_camera(self.cfg.camera_width, self.cfg.camera_height)

    def process_ring(
        self, packets, meta: np.ndarray, t_bounds: Optional[tuple[int, int]] = None
    ) -> FrameResult:
        """Run the frame on device-resident ring packets
        (``io.prefetch.PacketRing`` pre-staging), display-only with the
        packed-BGR plane: ``packets`` is the list of RingPackets covering
        the frame, ``meta`` the host (3, k) placement array from
        ``PacketRing.frame_meta``.

        With ``t_bounds`` (``io.prefetch.ring_time_bounds`` of the frame, as
        the pipe passes them), a 1-word ring and a ``one_word_layout``,
        kernel 1's ring entry reads the packet rows itself: nothing crosses
        the link at dispatch and nothing runs on the card before kernel 1.
        Any other frame -- a 2-word ring (``ring_layout`` is None), a dedup
        filter, or no ``t_bounds`` (the JAX package's signature) -- is a
        layout that entry does not cover: it is assembled by torch ops
        (``assemble_ring_frame[_compact]``) and runs ``depth_frame``, the
        filter and its priority included."""
        with span("engine.ring"):
            k = len(packets)
            if not (0 < k <= RING_SLOTS_PER_FRAME and meta.shape == (3, k)):
                raise ValueError(f"process_ring: {k} packets, meta {meta.shape}")
            kw = dict(display_only=True, display_packed=True)
            cap = self.cfg.event_capacity
            rows = tuple(p.xy for p in packets)
            if packets[0].tp is None:
                # compact one-word packets (PacketRing built with RingLayout)
                layout = self.ring_layout
                if layout is None:
                    raise ValueError("1-word ring packets need the engine's ring_layout")
                if t_bounds is not None and self.one_word_layout is not None:
                    return ring_depth_frame(rows, meta, t_bounds, layout, self.tables, self.cfg,
                                            self.plan, **kw)
                batch = assemble_ring_frame_compact(rows, meta, cap, layout)
            else:
                batch = assemble_ring_frame(rows, tuple(p.tp for p in packets), meta, cap)
            return depth_frame(batch, self.tables, self.cfg, self.plan, **kw)

    def dump_frame_csv(self, events: np.ndarray, csv_path: str) -> int:
        """Write one frame's per-event debug CSV: raw coords, rectified
        coords and disparity for every inlier (the reference's debug dump,
        depth_reprojection_pipe.py:19-34).  Returns the inlier count.

        Runs the per-event stage only (``ops.disparity``'s plain
        ``compute_event_disparity``; no scatter or tail) and fetches to the
        host; for offline inspection, not the hot path."""
        import csv

        from xmaps_tpu_torch.ops.disparity import compute_event_disparity

        batch = self.make_batch(events)
        res = compute_event_disparity(
            batch,
            self.tables.cam_mapx_i16,
            self.tables.cam_mapy_i16,
            self.tables.x_map,
            t_px_scale=self.cfg.t_px_scale,
        )
        keep = res.inlier.cpu().numpy()
        cols = [a.cpu().numpy()[keep] for a in
                (batch.x, batch.y, batch.t, res.x_rect, res.y_rect, res.disp)]
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["x", "y", "t", "x_r", "y_r", "disp"])
            w.writerows(zip(*cols))
        return int(keep.sum())

    def stage_group(self, frames: list, *, device=None) -> Union[EventBatch, CompactStagedGroup]:
        """F frames staged for ``group_depth_frames`` in one host buffer
        and one copy a field: at one word an event
        (``io.prefetch.stage_compact_group``) where ``one_word_layout`` is
        set, every timestamp is an integer and every pixel fits the layout
        (``io.prefetch.scan_group``); else as an ``EventBatch`` with a
        leading frame axis (the JAX engine's unsorted group staging).
        ``device``: where to (default: the engine's; a mesh row's in
        ``process_frames_sharded``)."""
        with span("engine.stage_group"):
            dev = self.device if device is None else device
            layout = self.one_word_layout
            cap = self.cfg.event_capacity
            scan = None
            with span("staging.check"):
                if layout is not None and all(np.issubdtype(ev.dtype["t"].type, np.integer)
                                              for ev in frames):
                    scan = scan_group(frames, layout, cap)
            if scan is not None and scan.fits:
                return stage_compact_group(frames, cap, layout, device=dev, scan=scan)
            with span("staging.copy"):
                return EventBatch.stack_structured(frames, cap, device=dev)

    def process_frames(
        self,
        frames: list,
        *,
        display_only: bool = False,
        display_packed: bool = False,
    ) -> list:
        """Run many independent frames as ONE program: kernel 1 once and
        the tail once for the group (``ops.frame_pipeline.group_depth_frames``;
        the multi-camera / offline-batch regime of the JAX engine's
        ``process_frames``).  Returns one ``FrameResult`` a frame, views
        into the group's outputs, each bit-equal to ``process_frame`` of
        that frame.  A list that mixes integer and float timestamps runs
        as one group a time kind (a group stacks one kind), its results
        in input order."""
        out = [None] * len(frames)
        for idx in _time_kinds(frames):
            staged = self.stage_group([frames[i] for i in idx])
            res = group_depth_frames(
                staged, self.tables, self.cfg, self.plan, layout=self.compact_layout,
                display_only=display_only, display_packed=display_packed,
            )
            for i, one in zip(idx, _unstack(res)):
                out[i] = one
        return out

    def process_frames_sharded(
        self,
        frames: list,
        mesh,
        *,
        display_only: bool = False,
        display_packed: bool = False,
    ) -> list:
        """Run many independent frames over the ``data`` axis of ``mesh``
        (a ``parallel.sharding.Mesh`` with event == 1; required: no device
        auto-pick), the counterpart of the JAX engine's
        ``process_frames_sharded``: the frames split into contiguous
        blocks, one a data row, each staged on its row's device
        (``stage_group(device=)``) and run as the ``process_frames``
        program there (one launch of kernel 1's group entry and one call
        of the tail's a row).  Returns one ``FrameResult`` a frame, on its
        row's device, bit-equal to ``process_frame``.

        The tables and the plan are copied once to each distinct device of
        the mesh and kept, so a virtual mesh of one card (a device listed
        k times) holds one copy, not k.  The JAX engine pads the list to a
        multiple of the data size with empty frames, since its program has
        one shape; here a block of ``ceil(n / data)`` frames a row leaves
        the last block short (and rows past it empty: no launch).  A list
        that mixes integer and float timestamps (which the JAX engine
        stacks as float) runs one group program a time kind on each row
        whose block holds that kind; each frame keeps the row its position
        gives it."""
        if not frames:
            return []
        if mesh.shape["event"] != 1:
            raise ValueError("process_frames_sharded: the group program is data-parallel "
                             "only: a mesh with event == 1")
        key = (mesh.key(), self.cfg)
        if key not in self._sharded:
            self._sharded[key] = make_group_sharded_pipeline(
                self.cfg, self.tables, mesh, self.plan, layout=self.compact_layout,
                cache=self._replicas)
        blocks = split_frames(len(frames), mesh.shape["data"])
        out = [None] * len(frames)
        for idx in _time_kinds(frames):
            keep = set(idx)
            index = [[i for i in range(b.start, b.stop) if i in keep] for b in blocks]
            group = shard_staged_group(frames, mesh, self.stage_group, index=index)
            rows = self._sharded[key](group, display_only=display_only,
                                      display_packed=display_packed)
            for ids, res in zip([ids for ids in index if ids], rows, strict=True):
                for i, one in zip(ids, _unstack(res), strict=True):
                    out[i] = one
        return out

    def set_frame_filter(self, name: str):
        """Select the frame dedup filter, one of ``ops.filters.FILTER_NAMES``
        (the E key's cycle); an unknown name raises ValueError and leaves
        the filter as it was.  A filtered pipeline stages 2 words an event
        (raw timestamps and polarity), see ``process_staged``."""
        check_filter_name(name)
        self.cfg = self.cfg.replace(frame_filter=name)
