"""ESL pipeline (``esl.denoise``: the bilateral filter's and the TV
denoise's launches over the group's stack): host µs a scan, over the window's calls."""

from benchmark.metrics import _scans


def read(run):
    return _scans.us_per_scan(run, "esl.denoise")
