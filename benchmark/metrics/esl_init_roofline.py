"""Kernels: ESL's init (kernel A ``csrc/esl.cu``, kernel B ``csrc/remap.cu``):
the share, in %, of the card's memory bandwidth that they reach, a call's
bytes (``benchmark.roofline_esl.group_bytes``) over the device time of the
kernels named below a call."""

from benchmark.roofline import hbm_bytes_per_s

KERNELS = ("esl_search_kernel", "remap_gather_kernel")


def read(run):
    b = run.values.get("bytes", {}).get("esl_init")
    calls = run.values.get("calls")
    if run.trace is None or not b or not calls:
        return None
    peak = hbm_bytes_per_s(run.values.get("card"))
    t = run.trace.kernel_seconds(KERNELS)
    if peak is None or t <= 0:
        return None
    return 100.0 * b / (t / calls) / peak
