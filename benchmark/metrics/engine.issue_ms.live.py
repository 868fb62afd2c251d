"""Engine (``XMapsDepthEngine.process_ring`` -> ``ops/frame_pipeline.py``):
the median host ms inside ``process_ring`` a frame (the enqueue)."""

import numpy as np


def read(run):
    d = run.durations("engine.process_ring")
    return float(np.median(d)) * 1e3 if d else None
