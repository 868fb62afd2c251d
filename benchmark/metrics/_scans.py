"""The ESL engine's spans, for the ``esl.*_us_per_scan.scans`` readers.

``ESLDepthEngine.process_scans`` records one ``esl.call`` span a call,
tagged with the call's scans, holding ``esl.stage``, ``esl.init``,
``esl.refine``, ``esl.denoise`` and ``esl.fetch`` (``PERF.md`` §3).  A
program without them gives None.
"""

from __future__ import annotations

from benchmark.metrics._records import load


def us_per_scan(run, name):
    """µs of the window's ``esl.call`` spans' ``name`` children over the
    scans those calls were tagged with (None without either)."""
    tree = load(run)
    calls = tree.in_window("esl.call") if tree is not None else []
    scans = sum(tree.recs[i].tag for i in calls)
    kids = [j for i in calls for j in tree.children(i, name) if tree.recs[j].end is not None]
    if not scans or not kids:
        return None
    return sum(tree.seconds(j) for j in kids) / scans * 1e6
