"""Engine (``XMapsDepthEngine.process_ring``: the frame's enqueue from its
resident ring packets): the median, over the window's triggering packets,
of the µs of the ``engine.ring`` span their handover holds."""

from benchmark.metrics import _records


def read(run):
    return _records.median_child_us(run, "engine.ring", below=True)
