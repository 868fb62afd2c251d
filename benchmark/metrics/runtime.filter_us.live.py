"""Runtime (the native polarity and activity filter): the median, over the
window's triggering packets (``pipe.packet`` spans that hand a frame over),
of the µs of their ``act+pol filter`` span."""

from benchmark.metrics import _records


def read(run):
    return _records.median_child_us(run, "act+pol filter")
