"""Runtime (``runtime/pipe.py``, the trigger finder, ``PacketRing.frame``):
the median, over the window's frames, of the ms from the trigger finder
handing a frame over to the engine's ``process_ring`` entered."""

import numpy as np


def read(run):
    handed = {tag: a for _, a, _, tag in run.in_window("pipe.frame")}
    gaps = [(a - handed[tag]) * 1e3 for _, a, _, tag in run.in_window("engine.process_ring")
            if tag in handed]
    return float(np.median(gaps)) if gaps else None
