"""Packet ring (``PacketRing.frame``: the frame's slots, meta and time
bounds): the median, over the window's triggering packets, of the µs of
the ``ring.frame`` span their handover holds."""

from benchmark.metrics import _records


def read(run):
    return _records.median_child_us(run, "ring.frame", below=True)
