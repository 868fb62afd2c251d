"""Group staging (``XMapsDepthEngine.stage_group``): µs a frame of packing
the 1-word rows, time binning included (``staging.pack``:
``io.prefetch._pack_compact``), over the window's frames."""

from benchmark.metrics import _records


def read(run):
    return _records.per_frame_us(run, "staging.pack")
