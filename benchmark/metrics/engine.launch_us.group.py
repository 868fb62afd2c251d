"""Engine (``ops.frame_pipeline.group_depth_frames``): the mean, over the
window's ``engine.group`` spans, of the µs of the ``kernel.launch`` spans
inside (``ops/_build.launch``: the device guard, the C entry, its check)."""

from benchmark.metrics import _records


def read(run):
    return _records.group_split_us(run, launches=True)
