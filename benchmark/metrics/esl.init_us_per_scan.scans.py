"""ESL pipeline (``esl.init``: kernels B, A, B a scan, their launches
included, then the group's depth): host µs a scan, over the window's calls."""

from benchmark.metrics import _scans


def read(run):
    return _scans.us_per_scan(run, "esl.init")
