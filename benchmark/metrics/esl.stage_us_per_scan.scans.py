"""ESL pipeline (``esl.stage``: each scan normalised on the host into the
pinned buffer, the one host-to-device copy enqueued): host µs a scan, over the window's calls."""

from benchmark.metrics import _scans


def read(run):
    return _scans.us_per_scan(run, "esl.stage")
