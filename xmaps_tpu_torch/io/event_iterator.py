"""Packetized event iteration from files (the streaming event source).

Port of ``xmaps_tpu.io.event_iterator``; mirrors NonBufferedBiasEventsIterator
(reference: bias_events_iterator.py:53-96): yields structured event chunks
of ``delta_t`` microseconds each -- the reference processes 4 packets per
projector frame (depth_reprojection.py:66-67).  Live capture has its own
source: ``io.capture.open_capture`` + ``LiveEventsIterator``.
"""

from __future__ import annotations

import os
import sys
from typing import Iterator, Optional

import numpy as np

from xmaps_tpu_torch.io.evt_decoder import EVENT_DTYPE, EvtDecoder
from xmaps_tpu_torch.utils.stats import span


class FileEventsIterator:
    """Replays a .raw/.dat/.npy event file in delta_t-sized packets.

    Args:
        input_filename: event file path.
        delta_t: packet span in microseconds.
        bias_file: accepted for interface parity; unused for file replay.
    """

    def __init__(
        self,
        input_filename: str,
        delta_t: float,
        bias_file: Optional[str] = None,
        loop: bool = False,
    ):
        if not input_filename:
            raise RuntimeError(
                "FileEventsIterator needs an input file (.raw/.dat/.npy); "
                "for live capture use io.capture.open_capture + "
                "LiveEventsIterator (pluggable backend registry)."
            )
        if not (os.path.exists(input_filename) and os.path.isfile(input_filename)):
            print(
                f"Error: provided input path '{input_filename}' does not exist "
                "or is not a file.",
                file=sys.stderr,
            )
            raise FileNotFoundError(input_filename)
        self.path = input_filename
        self.delta_t = int(delta_t)
        self.loop = loop
        self._decoder = EvtDecoder(input_filename)

    def get_size(self) -> tuple[int, int]:
        """(height, width) of the sensor, matching the Metavision API
        orientation (reference: bias_events_iterator.py:95-96)."""
        h = self._decoder.height or 480
        w = self._decoder.width or 640
        return h, w

    def __iter__(self) -> Iterator[np.ndarray]:
        pending = np.zeros(0, dtype=EVENT_DTYPE)
        t_next: Optional[int] = None
        for chunk in self._decoder:
            if len(chunk) == 0:
                continue
            with span("io.packetize"):
                pending = np.concatenate([pending, chunk]) if len(pending) else chunk
                if t_next is None:
                    t_next = int(pending["t"][0]) + self.delta_t
            # emit all complete packets; each span closes before its yield,
            # so the consumer's time is not the source's
            while True:
                with span("io.packetize"):
                    if not (len(pending) and int(pending["t"][-1]) >= t_next):
                        break
                    cut = int(np.searchsorted(pending["t"], t_next, side="left"))
                    packet, pending = pending[:cut], pending[cut:]
                    t_next += self.delta_t
                yield packet
        if len(pending):
            yield pending
