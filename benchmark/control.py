"""The comparison's two readings of a cell on the card: the program's, and
the control's (the plain reference one precision step down put in the
program's place), on several seeds, at the cell's own size and load.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 [--seconds 3]

Each seed is one measured window of ``--seconds`` (the cell's own traffic
and load); the program's outputs are then judged as a run judges them, and
the control's in their place.  One JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT  # run as a script: the checkout's root heads the path

from benchmark import harness  # noqa: E402


def readings(spec, workload, seed, seconds, device, root=harness.ROOT,
             cache_dir=os.path.join(harness.BUILD, "benchmark")) -> dict:
    """{"program": checks, "control": checks} of one window."""
    cell, cfg, traffic = harness.cell_parts(spec, workload, root)
    run = harness.Run(workload, cfg, traffic, seed, seconds, False, device, cache_dir)
    drv = harness.kind_module(traffic["kind"])
    state = drv.measure(run, time.perf_counter())
    drv.release(state)
    return {"program": drv.check(run, state), "control": drv.check(run, state, control=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    harness.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for seed in args.seeds:
        out = readings(spec, args.workload, seed, args.seconds, "cuda:0")
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
