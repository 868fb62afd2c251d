"""Runtime (the trigger finder's scan: the buffer's concatenation, the pause
search, the frame's cut): the median, over the window's triggering packets,
of the µs of their ``trigger.scan`` span less the ``pipe.handover`` inside it."""

import numpy as np

from benchmark.metrics import _records


def read(run):
    tree = _records.load(run)
    if tree is None:
        return None
    us = []
    for i in tree.triggering_packets():
        for j in tree.children(i, "trigger.scan"):
            handover = sum(tree.seconds(k) for k in tree.descendants(j, "pipe.handover"))
            us.append((tree.seconds(j) - handover) * 1e6)
    return float(np.median(us)) if us else None
