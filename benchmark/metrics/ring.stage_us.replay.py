"""Packet ring (``io/prefetch.py`` ``PacketRing.stage_packets``): the mean
host us a packet to pack it into its pinned row and copy it to the card."""

import numpy as np


def read(run):
    d = run.durations("ring.stage_packets")
    return float(np.mean(d)) * 1e6 if d else None
