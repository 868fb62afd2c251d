"""Group staging (``XMapsDepthEngine.stage_group``): µs a frame of the whole
staging (``engine.stage_group``: the check, the packing, the copy and what
lies between them), over the window's frames."""

from benchmark.metrics import _records


def read(run):
    return _records.per_frame_us(run, "engine.stage_group")
