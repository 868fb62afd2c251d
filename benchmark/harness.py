"""The benchmark harness: one cell, one run, one result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
its configuration (``configs[].file``), its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` names the module of
``benchmark/kinds/`` that plays it) and each per-layer metric's reader
(``benchmark/metrics/<name>.py``, a ``read(run)`` that returns a number or
None).  A later cell, mix or metric is added as files and a
``workloads`` entry.

A run: the kind's module builds the program and warms the cell's shapes (set-up),
measures ``--seconds`` (with ``--trace 1`` a profiled sub-window too),
hands back what the program produced, and the harness reads the device's
peak memory, checks that no JAX module was loaded, frees the program and
has that module compare the outputs with the plain reference.  The result
is one JSON line, last on standard output; the numbers compared, each
beside its limit, are the line's last key and the last lines on standard
error.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
#: caches of the program and the benchmark, at fixed paths in the checkout
BUILD = os.path.join(ROOT, "build")
FORBIDDEN = ("jax", "jaxlib", "flax", "xmaps_tpu")
#: the cores a run is held to: the program's host path is one thread, and on
#: a host shared with other machines a run moved between cores less spreads
#: less (PERF.md)
CORES = (2, 3)


def set_environment():
    """The program's caches at fixed paths in the checkout, and no JAX pulled
    in by a library: set before the program is imported."""
    os.environ["XMAPS_TORCH_BUILD_DIR"] = os.path.join(BUILD, "xmaps_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "benchmark", "triton")
    os.environ["USE_FLAX"] = "0"


def pin_cores():
    """Hold this process, and the threads it starts later, to ``CORES``
    (those of them it may use; none: left as it is)."""
    cores = set(CORES) & os.sched_getaffinity(0)
    if cores:
        os.sched_setaffinity(0, cores)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    return load_json(path)


def cell_parts(spec: dict, workload: str, root: str = ROOT) -> tuple:
    """(workload entry, configuration, traffic mix) of a cell, by name;
    the files relative to ``root`` (the checkout, or a test's own)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json"))
    return cell, cfg, traffic


def cell_metrics(spec: dict, workload: str, kind: str) -> list:
    """The cell's ``end_to_end`` or ``per_layer`` metric entries."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read`` function of a per-layer metric's file."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind_module(name: str):
    """The module of ``benchmark/kinds/`` that plays a traffic file's ``kind``."""
    return importlib.import_module(f"benchmark.kinds.{name}")


class Run:
    """One run's settings and records: the spans (name, start s, end s,
    tag) the kinds' modules take around the program's public entry points, the
    numbers they leave for the metric readers, and the device trace of a
    traced run."""

    def __init__(self, workload, cfg, traffic, seed, seconds, trace, device,
                 cache_dir=os.path.join(BUILD, "benchmark")):
        self.workload, self.cfg, self.traffic = workload, cfg, traffic
        self.seed, self.seconds, self.trace_on = int(seed), float(seconds), bool(trace)
        self.device = device
        self.cache_dir = cache_dir
        self.spans = []
        self.values = {}  # numbers a kind's module leaves for the readers
        self.trace = None  # benchmark.devtrace.DeviceTrace of a traced run
        self.setup_s = None
        self.window = None  # (start s, end s) of the measured window

    @contextmanager
    def span(self, name, tag=None):
        """Record a span around the block, in a traced run."""
        if not self.trace_on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter(), tag))

    def wrap(self, fn, name):
        """``fn`` recording a span of each call."""
        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return wrapped

    def in_window(self, name) -> list:
        """The spans of ``name`` that start in the window."""
        w0, w1 = self.window
        return [s for s in self.spans if s[0] == name and w0 <= s[1] < w1]

    def durations(self, name) -> list:
        """Seconds of each span of ``name`` in the window."""
        return [b - a for _, a, b, _ in self.in_window(name)]

    def idle_share(self):
        """The traced window's idle share of the device, in %."""
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s)


def card_and_power(device) -> tuple:
    """The card's name and its power limit in W (nvidia-smi)."""
    import torch

    name = torch.cuda.get_device_name(device)
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             f"--id={torch.device(device).index or 0}"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
        power = float(line.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        power = None
    return name, power


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def checks_ok(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: dict):
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None, root: str = ROOT,
             cache_dir: str = os.path.join(BUILD, "benchmark")) -> dict:
    """Measure and check one cell; the result object (module docstring).
    ``device="cpu"`` runs the program's plain versions (the tests only;
    no device metric is then a device's)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, traffic = cell_parts(spec, workload, root)
    run = Run(workload, cfg, traffic, seed, seconds, trace, device, cache_dir)
    drv = kind_module(traffic["kind"])
    state = drv.measure(run, t_start)
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": None, "count": int(cell["chips"]),
           "memory_peak_bytes": 0}
    if cuda:
        dev["kind"], dev["power_limit_w"] = card_and_power(device)
        run.values["card"] = dev["kind"]
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
    found = forbidden_modules()
    if found:
        print(f"loaded in the run's process: {found}", file=sys.stderr)
        raise SystemExit(3)
    drv.release(state)
    checks = drv.check(run, state)
    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in cell_metrics(spec, workload, kind):
        if kind == "end_to_end":
            value = run.setup_s if m["name"] == "setup_s" else state["e2e"].get(m["name"])
        else:
            value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": checks_ok(checks), "attempted": int(state["attempted"]),
           "failed": int(state["failed"]), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps(run.spans)}
    out["checks"] = checks
    return out


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_cores()
    set_environment()
    spec = load_spec()
    cell, _, _ = cell_parts(spec, args.workload)

    import torch

    print(f"python and torch imported in {time.perf_counter() - t_start:.6f} s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", t_start)
    print_checks(out["checks"])
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0
