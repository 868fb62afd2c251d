"""ESL pipeline (``esl.fetch``: the four planes' device-to-host copies
enqueued and the call's one synchronise): host µs a scan, over the window's calls."""

from benchmark.metrics import _scans


def read(run):
    return _scans.us_per_scan(run, "esl.fetch")
