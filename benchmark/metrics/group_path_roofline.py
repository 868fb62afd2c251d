"""Kernels of the group path (``csrc/events.cu``, ``csrc/tail.cu``): the
share, in %, of the card's memory bandwidth that a group call reaches,
the bytes it must move (``benchmark.roofline.group_bytes``) over the
device's busy time (the union of its intervals, whatever kernels run)
a call in the traced window."""

from benchmark.roofline import hbm_bytes_per_s


def read(run):
    b = run.values.get("bytes", {}).get("group_path")
    calls = run.values.get("calls")
    if run.trace is None or not b or not calls:
        return None
    peak = hbm_bytes_per_s(run.values.get("card"))
    busy = run.trace.busy_s()
    if peak is None or busy <= 0:
        return None
    return 100.0 * b / (busy / calls) / peak
