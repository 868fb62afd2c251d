"""Packet ring (``PacketRing.stage_packets``): the median, over the window's
triggering packets, of the µs of their ``prestage packet`` span."""

from benchmark.metrics import _records


def read(run):
    return _records.median_child_us(run, "prestage packet")
