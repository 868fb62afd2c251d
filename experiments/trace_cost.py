#!/usr/bin/env python3
"""What the tracer of ``xmaps_tpu_torch.utils.stats`` costs a span site.

Run from the root of a checkout:  python3 experiments/trace_cost.py

Times, in ns a site, ``with span(...)`` and a dashboard timer
(``StatsPrinter.measure_time``) against an empty loop, with no profiler
(the tracer off: one flag read) and inside a ``torch.profiler`` session of
CUDA activity only, as the benchmark's traced runs open it (CPU activity
where there is no card; the tracer on: clock reads and a record each).
Each figure is the median of 7 rounds of 200,000 sites.  Prints one JSON line, with the
card's name and power limit where there is a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from xmaps_tpu_torch.utils import stats  # noqa: E402
from xmaps_tpu_torch.utils.stats import StatsPrinter, span  # noqa: E402

N = 200_000
ROUNDS = 7


def sites(kind: str) -> float:
    """Seconds of N sites of ``kind``."""
    sp = StatsPrinter(silent=True)
    stats.clear()
    t = time.perf_counter()
    if kind == "empty":
        for _ in range(N):
            pass
    elif kind == "span":
        for _ in range(N):
            with span("site"):
                pass
    elif kind == "measure_time":
        for _ in range(N):
            with sp.measure_time("site"):
                pass
    out = time.perf_counter() - t
    stats.clear()
    return out


def ns_per_site() -> dict:
    kinds = ("empty", "span", "measure_time")
    secs = {k: [] for k in kinds}
    for _ in range(ROUNDS):
        for k in kinds:
            secs[k].append(sites(k))
    base = statistics.median(secs["empty"])
    return {k: round((statistics.median(v) - base) / N * 1e9, 1)
            for k, v in secs.items() if k != "empty"}


def main() -> int:
    cuda = torch.cuda.is_available()
    off = ns_per_site()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        on = ns_per_site()
    doc = {"off_ns": off, "on_ns": on, "sites": N, "rounds": ROUNDS,
           "torch": torch.__version__, "gpu": None, "power_limit_w": None}
    if cuda:
        doc["gpu"] = torch.cuda.get_device_name(0)
        try:
            doc["power_limit_w"] = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, check=True, timeout=30).stdout.split()[0])
        except (OSError, subprocess.SubprocessError, ValueError, IndexError):
            pass
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
