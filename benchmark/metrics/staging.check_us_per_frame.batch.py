"""Group staging (``XMapsDepthEngine.stage_group``): µs a frame of the scan
of the frames' time dtype and pixel widths that picks the 1-word staging
(``staging.check``), over the window's frames."""

from benchmark.metrics import _records


def read(run):
    return _records.per_frame_us(run, "staging.check")
