"""Engine (``ops.frame_pipeline.group_depth_frames``): the mean, over the
window's ``engine.group`` spans, of their µs less the ``kernel.launch``
spans inside: the Python and torch glue around the launches."""

from benchmark.metrics import _records


def read(run):
    return _records.group_split_us(run, launches=False)
