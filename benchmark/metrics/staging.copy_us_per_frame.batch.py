"""Group staging (``XMapsDepthEngine.stage_group``): µs a frame of the pinned
buffer's allocation and the copy's enqueue (``staging.copy``, two spans a
group), over the window's frames."""

from benchmark.metrics import _records


def read(run):
    return _records.per_frame_us(run, "staging.copy")
