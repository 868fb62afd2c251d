"""Device: the share, in %, of the traced window's device-idle time (the
window less the union of the device's busy intervals) that lies inside the
event source's spans (``io.decode``, ``io.packetize``): how much of the
card's idleness the decoding and packet cutting explain."""

from benchmark.metrics import _records


def read(run):
    tree = _records.load(run)
    if tree is None or run.trace is None or run.trace.window is None:
        return None
    source = sorted((r.start * 1e6, r.end * 1e6) for r in tree.recs
                    if r.name in ("io.decode", "io.packetize") and r.end is not None)
    lo, hi = run.trace.window
    edges = [lo] + [x for iv in run.trace.busy_intervals() for x in iv] + [hi]
    idle = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    idle_us = sum(b - a for a, b in idle)
    if not source or idle_us <= 0:
        return None
    inside = sum(max(0.0, min(b, d) - max(a, c)) for a, b in idle for c, d in source)
    return 100.0 * inside / idle_us
