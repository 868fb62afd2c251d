"""Engine (``process_frames`` / ``ops.frame_pipeline.group_depth_frames``):
the mean host us inside a group call."""

import numpy as np


def read(run):
    d = run.durations("group.call")
    return float(np.mean(d)) * 1e6 if d else None
