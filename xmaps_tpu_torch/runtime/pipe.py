"""Pipeline wiring: packets -> filters -> trigger finder -> device frame.

Port of ``xmaps_tpu.runtime.pipe``, the orchestration equivalent of the
reference DepthReprojectionPipe (depth_reprojection_pipe.py:38-176).
Per-packet path: watchdog -> fused polarity+activity filter (native C++)
-> packet-ring prestaging (``io.prefetch.PacketRing``: each filtered
packet is packed into a pinned host row and copied to its device row as it
arrives) -> trigger finder.  Per-frame path: the engine's frame on the
packets already on the device (``process_ring``: on CUDA kernel 1's ring
entry reads the rows, then kernel 2 or 3), plus the handoff of the
finished frame to the display callback.  A frame whose packets are not all
resident (ring overrun, packets skipped while the watchdog was behind) is
counted as ``ring fallback`` and staged segmented: pinned host slots with
one non-blocking copy, then ``process_staged``; ``prestage=False`` stages
every frame so.

The frame runs on the engine's stream while the host segments the next
one: a frame is fetched (or its inlier count read, which synchronises) only
when the next frame is dispatched, or at once with ``low_latency``.  The
ring's copies and the frames that read its rows run on that one stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from xmaps_tpu_torch.config import RuntimeParams
from xmaps_tpu_torch.io.filters import ActivityNoiseFilter
from xmaps_tpu_torch.io.prefetch import HostStagingPool, PacketRing
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
from xmaps_tpu_torch.ops.filters import FILTER_NAMES
from xmaps_tpu_torch.runtime.trigger_finder import RobustTriggerFinder
from xmaps_tpu_torch.runtime.watchdog import TimingWatchdog
from xmaps_tpu_torch.utils.stats import SingleTimer, StatsPrinter, span


@dataclass
class DepthReprojectionPipe:
    params: RuntimeParams
    stats_printer: StatsPrinter
    frame_callback: Callable[[np.ndarray], None]

    engine: Optional[XMapsDepthEngine] = None

    #: the device of the engine built from ``params`` when ``engine`` is
    #: None ("cuda" or "cpu"); a given engine keeps its own device
    device: str = "cuda"

    #: True = flush each frame synchronously (lowest latency); False =
    #: keep one frame in flight so device compute overlaps segmentation
    #: (highest throughput, plus ~1 frame of display delay).
    low_latency: bool = False

    #: Pre-stage every filtered packet to the device as it arrives
    #: (io.prefetch.PacketRing): the frame's event data is already on the
    #: device when the trigger fires, so dispatch ships nothing.  Falls
    #: back to segmented staging per frame on ring overrun.
    prestage: bool = True

    #: Optional display-demand probe, called once per finished frame.
    #: When it returns False the full-resolution frame is never fetched
    #: from the device -- only the 4-byte inlier count (stats +
    #: backpressure).  Sinks that show every Nth frame (FileSinkWindow)
    #: or none at all would otherwise pay the device->host image copy for
    #: frames nobody looks at.
    frame_wanted: Optional[Callable[[], bool]] = None

    trigger_finder: RobustTriggerFinder = field(init=False)
    watchdog: TimingWatchdog = field(init=False)
    act_filter: ActivityNoiseFilter = field(init=False)

    _filter_idx: int = 0
    _pending: Optional[object] = None  # in-flight device FrameResult
    _packets: int = 0  # packets seen, the ``pipe.packet`` spans' tag
    _frames: int = 0  # frames handed over, the ``pipe.handover`` spans' tag

    def __post_init__(self):
        p = self.params
        self.act_filter = ActivityNoiseFilter(
            p.camera_width,
            p.camera_height,
            window_us=int(1e6 / p.projector_fps),
            keep_polarity=1,
        )

        if self.engine is None:
            with SingleTimer("Setting up calibration, maps and X-map"):
                self.engine = XMapsDepthEngine.from_runtime_params(
                    p, device=self.device
                )

        self.staging = HostStagingPool(
            self.engine.cfg.event_capacity,
            depth=2,
            device=self.engine.device,
            layout=self.engine.compact_layout,
        )

        # Slot capacity tracks the arrival-packet size (a quarter frame),
        # not the frame capacity; the compact RingLayout (one word an
        # event; polarity is implied by the upstream filter) applies when
        # the camera dims permit.
        self.ring = (
            PacketRing(
                packet_capacity=max(2048, self.engine.cfg.event_capacity // 4),
                device=self.engine.device,
                layout=self.engine.ring_layout,
            )
            if self.prestage
            else None
        )

        self.trigger_finder = RobustTriggerFinder(
            projector_fps=p.projector_fps,
            stats=self.stats_printer,
            frame_callback=self.process_ev_frame,
            frame_callback_indexed=(
                self.process_ev_frame_indexed if self.ring else None
            ),
        )
        self.watchdog = TimingWatchdog(
            stats_printer=self.stats_printer, projector_fps=p.projector_fps
        )

    # -- per packet -------------------------------------------------------

    def process_events(self, evs: np.ndarray):
        self._packets += 1
        with span("pipe.packet", self._packets):
            behind = (
                self.watchdog.is_processing_behind(evs)
                and self.params.should_drop_frames
            )
            if behind:
                self.trigger_finder.drop_frame()

            with self.stats_printer.measure_time("act+pol filter"):
                evs = self.act_filter.process(evs)

            if self.ring is not None and len(evs):
                if behind:
                    # The watchdog is dropping frames to catch up: shipping a
                    # doomed frame's bytes would only deepen the lag.  Keep the
                    # ring's numbering in sync; a surviving frame that spans
                    # this range takes the segmented fallback.
                    self.ring.skip_events(len(evs))
                else:
                    with self.stats_printer.measure_time("prestage packet"):
                        self.ring.stage_packets(evs)

            self.trigger_finder.process_events(evs)
            if self.ring is not None:
                # everything below the finder's buffer base is final, emitted
                # or not: free those packets after every packet (the JAX pipe
                # frees them only after a dispatched frame, so a run of dropped
                # or failed frames fills its ring and the next frames fall back)
                self.ring.retire_below(self.trigger_finder.buffer_global_base)

    # -- per frame ---------------------------------------------------------

    def process_ev_frame_indexed(self, evs: np.ndarray, gstart: int):
        """Indexed trigger-finder callback (pre-staging mode): the frame's
        events are already device-resident ring packets; dispatch ships
        nothing."""
        self._frames += 1
        with span("pipe.handover", self._frames):
            self._flush_pending()
            if not self._dispatch_ring(evs, gstart):
                # overrun/hole: this frame's packets are not (all) resident
                self.stats_printer.count("ring fallback")
                self._dispatch_segmented(evs)
            if self.low_latency:
                self._flush_pending()

    def _dispatch_ring(self, evs: np.ndarray, gstart: int) -> bool:
        """Dispatch the frame from its resident packets; False where they
        are not all resident."""
        args = self.ring.frame(gstart, evs, self.engine.cfg.event_capacity)
        if args is None:
            return False
        with self.stats_printer.measure_time("dispatch frame"):
            self._pending = self.engine.process_ring(*args)
        self.stats_printer.count("frames dispatched")
        return True

    def process_ev_frame(self, evs: np.ndarray):
        """Trigger-finder callback: one frame of events -> device frame.

        The previous frame's result is collected first, so device compute
        overlaps with the next frame's host-side segmentation (double
        buffering; the staging alternates host slots).
        """
        self._frames += 1
        with span("pipe.handover", self._frames):
            self._flush_pending()
            self._dispatch_segmented(evs)
            if self.low_latency:
                self._flush_pending()

    def _dispatch_segmented(self, evs: np.ndarray):
        with self.stats_printer.measure_time("stage batch"):
            # reused pinned host slots, packed words, one non-blocking
            # copy per array (io.prefetch).  Unfiltered pipelines ship ONE
            # word/event (host-binned time); dedup filters need raw
            # timestamps, so they use the 2-word form.
            if (
                self.engine.compact_layout is not None
                and self.engine.cfg.frame_filter == "none"
            ):
                batch = self.staging.stage_compact(evs)
            else:
                batch = self.staging.stage(evs)
        with self.stats_printer.measure_time("dispatch frame"):
            result = self.engine.process_staged(batch)
        self._pending = result
        self.stats_printer.count("frames dispatched")

    def _flush_pending(self):
        if self._pending is None:
            return
        if self.frame_wanted is not None and not self.frame_wanted():
            # display skipped: sync on the scalar only (completion proof;
            # the image stays on the device)
            with self.stats_printer.measure_time("fetch stats"):
                self.stats_printer.add_metric(
                    "frame inliers", int(self._pending.num_inliers)
                )
            self._pending = None
            self.stats_printer.count("frames computed (display skipped)")
            return
        with self.stats_printer.measure_time("fetch frame"):
            frame = fetch_display_frame(self._pending)
            self.stats_printer.add_metric(
                "frame inliers", int(self._pending.num_inliers)
            )
        self._pending = None
        self.frame_callback(frame)

    def flush(self):
        """Drain the in-flight frame (call at end of stream)."""
        self._flush_pending()

    # -- runtime controls ---------------------------------------------------

    def select_next_frame_event_filter(self) -> str:
        """Cycle the frame dedup filter (reference E key,
        depth_reprojection_pipe.py:169-171).  The next frame is staged at 2
        words an event for a filter, 1 word for "none"."""
        self._filter_idx = (self._filter_idx + 1) % len(FILTER_NAMES)
        name = FILTER_NAMES[self._filter_idx]
        self.engine.set_frame_filter(name)
        self.stats_printer.log(f"Selected event filter: {name}")
        return name

    def reset(self):
        self.flush()
        self.watchdog.reset()
        self.trigger_finder.reset()
        self.act_filter.reset()
        if self.ring is not None:
            self.ring.reset()


def fetch_display_frame(result) -> np.ndarray:
    """A finished frame's packed-BGR plane (B | G<<8 | R<<16 in int32) on
    the host as (H, W, 3) uint8 BGR: the device skips the channel split;
    this host view + copy runs at display rate only."""
    packed = result.frame_bgr.cpu().numpy()
    h, w = packed.shape
    return np.ascontiguousarray(packed.view(np.uint8).reshape(h, w, 4)[..., :3])
