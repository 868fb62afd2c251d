"""Kernels: the projector tail (dilate, remap, colorize; ``csrc/tail.cu``):
the share, in %, of the card's memory bandwidth that a group's tail
reaches, its bytes (``benchmark.roofline.group_bytes``) over the device
time of the kernels named below a call."""

from benchmark.roofline import hbm_bytes_per_s

KERNELS = ("tail_dilate", "tail_remap_colorize")


def read(run):
    b = run.values.get("bytes", {}).get("tail")
    calls = run.values.get("calls")
    if run.trace is None or not b or not calls:
        return None
    peak = hbm_bytes_per_s(run.values.get("card"))
    t = run.trace.kernel_seconds(KERNELS)
    if peak is None or t <= 0:
        return None
    return 100.0 * b / (t / calls) / peak
