"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for
(``python3 -m benchmark.run`` works too).  The kernel library, the engine's
maps and the traffic are cached under ``build/`` in the checkout.
"""

import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    # run as a script, this folder heads the import path: the checkout's root takes its place
    if sys.path and os.path.abspath(sys.path[0]) == here:
        sys.path[0] = root
    elif root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.harness import main

    sys.exit(main(t_start=T_START))
