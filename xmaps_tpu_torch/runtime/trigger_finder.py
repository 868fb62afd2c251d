"""Frame segmentation: find projector frame boundaries in the event stream.

Host-side O(n) scan over int64 timestamps (reference: trigger_finder.py:
91-189).  A scanning laser projector pauses between frames (vertical
blanking); a "pause" is an inter-event gap >= FRAME_PAUSED_THRESH_US.  A
valid frame is a pause-to-pause span in (T/2, T] containing more than
MIN_EVENTS_PER_FRAME events.  The segmentation is control-flow heavy and
operates on the freshly decoded host arrays, so it stays on the host; the
per-frame math downstream is one device program.

This implementation keeps plain NumPy arrays in a list (the reference pools
Metavision EventCDBuffers; our decoder already hands us NumPy, so a free
list is unnecessary -- buffers are reused by the host allocator).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from xmaps_tpu_torch.config import FRAME_PAUSED_THRESH_US, MIN_EVENTS_PER_FRAME
from xmaps_tpu_torch.utils.stats import StatsPrinter, span


@dataclass
class EventBufferList:
    """FIFO of event chunks with cheap span/length queries
    (reference: trigger_finder.py:11-89)."""

    _bufs: List[np.ndarray] = field(default_factory=list)

    def append(self, evs: np.ndarray):
        if len(evs):
            self._bufs.append(evs)

    def clear(self):
        self._bufs.clear()

    def empty(self) -> bool:
        return not self._bufs

    def first_ev_time(self) -> int:
        return int(self._bufs[0]["t"][0]) if self._bufs else -1

    def last_ev_time(self) -> int:
        return int(self._bufs[-1]["t"][-1]) if self._bufs else -1

    def time_span_us(self) -> int:
        if not self._bufs:
            return -1
        return self.last_ev_time() - self.first_ev_time()

    def num_events(self) -> int:
        return sum(len(b) for b in self._bufs)

    def drop(self, drop_len_ms: float) -> int:
        """Drop whole chunks from the front covering drop_len_ms
        (reference: trigger_finder.py:62-74).  Returns how many events
        were dropped (0 = nothing to drop)."""
        if self.empty():
            return 0
        drop_until_us = self.first_ev_time() + drop_len_ms * 1000
        dropped = 0
        while not self.empty() and self.first_ev_time() < drop_until_us:
            dropped += len(self._bufs.pop(0))
        return dropped

    def pop_all(self) -> np.ndarray:
        out = (
            np.concatenate(self._bufs)
            if len(self._bufs) > 1
            else (self._bufs[0] if self._bufs else np.zeros(0))
        )
        self._bufs.clear()
        return out

    def push(self, evs: np.ndarray):
        assert self.empty()
        if len(evs):
            self._bufs.append(evs)


@dataclass
class RobustTriggerFinder:
    """Accumulates event packets and emits one frame of events per projector
    period through frame_callback (reference: trigger_finder.py:91-189)."""

    projector_fps: int
    stats: StatsPrinter
    frame_callback: Callable[[np.ndarray], None]

    #: when set, called as (frame_events, global_start_index) instead of
    #: frame_callback.  The global index counts every event ever passed to
    #: process_events (the post-filter packet stream), so a pre-staging
    #: consumer (io.prefetch.PacketRing) that numbers the same stream can
    #: map the frame onto its device-resident packets.
    frame_callback_indexed: Optional[Callable[[np.ndarray, int], None]] = None

    frame_paused_thresh_us: int = FRAME_PAUSED_THRESH_US
    min_events_per_frame: int = MIN_EVENTS_PER_FRAME

    should_drop: bool = False
    last_frame_start_us: int = -1

    _ev_buf: EventBufferList = field(default_factory=EventBufferList)
    #: global index of the first buffered event
    _gbase: int = 0

    @property
    def frame_len_ms(self) -> float:
        return 1e3 / self.projector_fps

    @property
    def buffer_global_base(self) -> int:
        """Global index of the first still-buffered event; everything
        below it is final (emitted, dropped or discarded)."""
        return self._gbase

    def reset(self):
        self._ev_buf.pop_all()
        self.should_drop = False
        self.last_frame_start_us = -1
        self._gbase = 0

    def drop_frame(self):
        self.should_drop = True

    def process_events(self, evs: np.ndarray):
        self._ev_buf.append(evs)

        if self.should_drop:
            dropped = self._ev_buf.drop(self.frame_len_ms)
            if dropped:
                self._gbase += dropped
                self.stats.count("frames dropped")
                self.should_drop = False
            else:
                return

        if self._ev_buf.empty():
            return
        if self._ev_buf.time_span_us() < 1e6 / self.projector_fps:
            return

        self.stats.add_metric("evs in buf", self._ev_buf.num_events())
        # the whole scan: the buffer's concatenation, the pause search and
        # the frame's handover
        with span("trigger.scan"):
            ev_time = self.find_trigger()
        if ev_time > 0:
            self.stats.count("trig ok")
        else:
            self.stats.count("trig fail")

    def find_trigger(self) -> float:
        """Scan buffered events for a frame's start/end pauses; emits the
        frame via frame_callback and keeps the remainder buffered.  Returns
        the frame start time in us, or -1."""
        evs = self._ev_buf.pop_all()

        # the pause search alone (np.diff), not the concatenation above
        with self.stats.measure_time("find pauses"):
            pauses = np.nonzero(
                np.diff(evs["t"]) >= self.frame_paused_thresh_us
            )[0]

        frame_period_us = 1e6 / self.projector_fps
        for prev_idx, next_idx in zip(pauses[:-1], pauses[1:]):
            span = evs["t"][next_idx] - evs["t"][prev_idx]
            if span <= frame_period_us / 2:
                continue
            if span <= frame_period_us and next_idx - prev_idx > self.min_events_per_frame:
                # trim the boundary events (reference trigger_finder.py:172)
                frame = evs[prev_idx + 2 : next_idx - 2]
                if self.frame_callback_indexed is not None:
                    self.frame_callback_indexed(
                        frame, self._gbase + int(prev_idx) + 2
                    )
                else:
                    self.frame_callback(frame)
                start_time = int(evs["t"][prev_idx + 2])
                end_time = int(evs["t"][next_idx - 2])
                self.stats.add_metric("frame len [ms]", (end_time - start_time) / 1e3)
                if self.last_frame_start_us != -1:
                    self.stats.add_metric(
                        "frame interval [ms]",
                        (start_time - self.last_frame_start_us) / 1e3,
                    )
                self.last_frame_start_us = start_time
                self._ev_buf.push(evs[next_idx - 2 :])
                self._gbase += int(next_idx) - 2
                return start_time
            # malformed gap structure: discard up to the second pause
            self.stats.count(
                "trig span too long" if span > frame_period_us else "trig too few events"
            )
            self._ev_buf.push(evs[next_idx:])
            self._gbase += int(next_idx)
            return -1
        # No pause pair spanning more than half a frame yet.  The reference
        # discards the whole run here (trigger_finder.py:189), which
        # livelocks on noise-free streams where each buffer holds only one
        # blanking gap; instead keep the tail from the last pause onward
        # (the gap event included, so the pause stays detectable) and wait
        # for the next frame's gap.
        if len(pauses):
            self._ev_buf.push(evs[pauses[-1] :])
            self._gbase += int(pauses[-1])
        else:
            self._gbase += len(evs)
        return -1
