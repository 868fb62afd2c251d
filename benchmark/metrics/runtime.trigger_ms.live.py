"""Runtime on the host (the polarity and activity filter, ``PacketRing.stage_packets``,
the trigger finder): the median, over the window's frames, of the ms from
the pipe starting on the packet that completes a frame's trigger to the
trigger finder handing the frame over."""

import bisect

import numpy as np


def read(run):
    starts = sorted(s[1] for s in run.spans if s[0] == "pipe.process_events")
    gaps = []
    for _, h, _, _ in run.in_window("pipe.frame"):
        i = bisect.bisect_right(starts, h) - 1
        if i >= 0:
            gaps.append((h - starts[i]) * 1e3)
    return float(np.median(gaps)) if gaps else None
