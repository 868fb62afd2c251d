"""Micro-benchmark: last-write-wins scatter stores into one tile (kernel S).

Counterpart of ``eval/bench_store_loop.py``: N = 28 * 1024 events (rows,
cols and uint32 values from ``numpy.random.default_rng(0)``, drawn in the
same order) stored into a zeroed (64, 1152) uint32 tile, one tail band of
the ESL crop.  Three versions of that function are timed:

- ``kernel``: ``ops.store_loop.tile_store_last`` (``csrc/store_loop.cu`` on
  the card; its plain version on the CPU);
- ``plain``: ``tile_store_last_plain`` (a scatter-max of the event index,
  then a gather);
- ``library``: one ``index_put_`` of the values under
  ``torch.use_deterministic_algorithms(True)``.  ``library_equal`` says
  whether it computed the same tile as the plain version (last write wins
  on duplicate cells); where it did not, its time is that of another
  function and serves only as a yardstick, as the JAX benchmark's XLA
  ``unique_indices=True`` set does.

On the card each version runs ITERS times under torch.profiler, in two
turns (plain, kernel, library, library, kernel, plain), and its time is the
device's: the summed duration of the kernels (and copies)
a call launched, without the host's issue time or the gaps between
launches.  On the CPU it is the host clock.  Prints one JSON line of ms per
call (the mean of the two turns, and each turn) and ns per store.

    python -m xmaps_tpu_torch.apps.bench_store_loop                # the card
    python -m xmaps_tpu_torch.apps.bench_store_loop --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from xmaps_tpu_torch.ops.store_loop import (
    BENCH_EVENTS,
    BENCH_SHAPE,
    tile_store_last,
    tile_store_last_plain,
)

#: the JAX benchmark's seed
SEED = 0
#: calls a version is timed over, in each of its two turns
ITERS = 200


def make_inputs(n: int, shape: tuple[int, int], seed: int = SEED, device="cpu"):
    """(rows, cols, vals) as int32 tensors on ``device``: the JAX
    benchmark's draws (vals are uint32 in [1, 2**30), held as int32)."""
    H, W = shape
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, H, n).astype(np.int32)
    cols = rng.integers(0, W, n).astype(np.int32)
    vals = rng.integers(1, 1 << 30, n).astype(np.uint32).view(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (rows, cols, vals))


def library_store(rows_l, cols_l, vals, shape):
    """``index_put_`` of ``vals`` at (rows_l, cols_l) (int64) into a zeroed
    tile, under deterministic algorithms."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out = torch.zeros(shape, dtype=torch.int32, device=vals.device)
        return out.index_put_((rows_l, cols_l), vals)
    finally:
        torch.use_deterministic_algorithms(was)


def time_ms(fn, iters: int, device: torch.device) -> float:
    """ms per call of ``fn`` over ``iters`` calls after a warm-up: on CUDA
    the device time (the summed duration of every device event the calls
    launched, under torch.profiler); on the CPU the host clock."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # an empty session first: device records of the work before it that
    # are still buffered are delivered to it, not counted below
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if not us:
        raise RuntimeError("torch.profiler recorded no device event")
    return us / 1e3 / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda requested but torch.cuda.is_available() is False; "
            "pass --device cpu to time the plain versions"
        )
    shape = BENCH_SHAPE
    rows, cols, vals = make_inputs(BENCH_EVENTS, shape, device=device)
    rows_l, cols_l = rows.long(), cols.long()
    want = tile_store_last_plain(rows, cols, vals, shape)
    if not torch.equal(tile_store_last(rows, cols, vals, shape), want):
        raise AssertionError("tile_store_last differs from its plain version")
    library_equal = torch.equal(library_store(rows_l, cols_l, vals, shape), want)
    fns = {
        "kernel": lambda: tile_store_last(rows, cols, vals, shape),
        "plain": lambda: tile_store_last_plain(rows, cols, vals, shape),
        "library": lambda: library_store(rows_l, cols_l, vals, shape),
    }
    turns = {k: [] for k in fns}
    for k in ("plain", "kernel", "library", "library", "kernel", "plain"):
        turns[k].append(time_ms(fns[k], ITERS, device))
    result = {
        "metric": "ns_per_store",
        "events": BENCH_EVENTS,
        "shape": list(shape),
        "seed": SEED,
        "device": device.type,
        "gpu": torch.cuda.get_device_name(device) if device.type == "cuda" else None,
        "timing": "profiler_device" if device.type == "cuda" else "host_clock",
        "iters": ITERS,
        "library": "index_put_ (deterministic)",
        "library_equal": library_equal,
    }
    for k, ts in turns.items():
        ms = sum(ts) / len(ts)
        result[f"{k}_ms"] = ms
        result[f"{k}_turns_ms"] = ts
        result[f"{k}_ns_per_store"] = ms * 1e6 / BENCH_EVENTS
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
