"""Per-op attribution of the ESL-init scan on one GPU.

Port of the repository's ``eval/profile_esl_init.py``.  The footprint-crop
depth init of ``apps.bench_esl_init`` (the synthetic ESL rig, seed-3 scan:
kernel B into the box, kernel A, kernel B back, depth) runs as groups of 4
scans, three groups under torch.profiler (``utils.profiling.device_events``:
between two marker kernels, with untimed calls on each side), and each
device event's time is summed by name: how much of a scan is kernel A,
kernel B and the torch ops around them.  ``module_ms`` is a group's span
from its first device event to its last, a scan; ``ops_total_ms`` the
summed device events a scan.  On ``cuda`` a window without device events
raises.  On the CPU there are no device events: the line then attributes
the host's time by op (torch.profiler's self CPU time, ``module_ms`` the
host clock), and says so in ``clock``.  Prints the top ops, then ONE JSON
line (the top 12 by name, each cut to 80 characters).

    python -m xmaps_tpu_torch.apps.profile_esl_init                  # on the card
    python -m xmaps_tpu_torch.apps.profile_esl_init --device cpu \\
        --camera 96 72 --projector 45 80                            # plain versions
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

from xmaps_tpu_torch.apps.bench_esl_init import RIG, EslInit
from xmaps_tpu_torch.apps.measure import add_rig_args, call_spans, card, sync
from xmaps_tpu_torch.models.depth_pipeline import resolve_device

#: scans a group, and the profiled groups
REPS = 4
RUNS = 3
TOP = 12
#: characters of an op's name kept in the line
NAME_CHARS = 80


def short_name(name: str) -> str:
    """A device event's or op's name without ``void `` and anonymous
    namespaces, cut to ``NAME_CHARS``."""
    return name.replace("void ", "").replace("(anonymous namespace)::", "")[:NAME_CHARS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    add_rig_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    esl = EslInit(dev, args.camera, args.projector)

    def group():
        return [esl.crop(esl.cam) for _ in range(REPS)]

    group()
    sync(dev)
    scans = RUNS * REPS
    by_name = collections.defaultdict(float)
    count = collections.Counter()
    if dev.type == "cuda":
        from xmaps_tpu_torch.utils.profiling import device_events

        events = device_events(group, RUNS)
        if not events:
            raise RuntimeError("torch.profiler recorded no device event of the scan")
        for name, _, us in events:
            by_name[short_name(name)] += us
            count[short_name(name)] += 1
        module_us = sum(call_spans(events, RUNS))
        clock = "device (CUDA events of the profiler)"
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            for _ in range(RUNS):
                group()
            module_us = (time.perf_counter() - t0) * 1e6
        for e in prof.key_averages():
            by_name[short_name(e.key)] += e.self_cpu_time_total
            count[short_name(e.key)] += e.count
        clock = "host (self CPU time of the profiler's ops)"
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    print(f"# module: {module_us / scans / 1e3:.5f} ms/scan; ops total: "
          f"{total / scans / 1e3:.5f} ms/scan ({clock})")
    print("# top ops:")
    for name, us in top:
        print(f"{us / scans / 1e3:10.5f} ms/scan  x{count[name]:5d}  {name}")
    print(json.dumps({
        "metric": "esl_init_op_attribution_ms_per_scan",
        "module_ms": module_us / scans / 1e3,
        "ops_total_ms": total / scans / 1e3,
        "busy_share": total / module_us if module_us else None,
        "top": {name: us / scans / 1e3 for name, us in top},
        "scans": scans,
        "clock": clock,
        "calib": RIG,
        "device": dev.type,
        **card(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
