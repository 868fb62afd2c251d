"""Weak scaling of the multi-device pipeline over (data, event) meshes.

Port of the repository's ``eval/bench_scaling.py``.  The mesh is
``--devices`` distinct devices (``cuda:0`` .. ``cuda:N-1``, or the CPU),
each listed ``--virtual`` times: a repeated device is a virtual device,
as XLA's forced host devices are in the JAX script.  On a machine with
one card, ``--virtual 4`` runs every sharded program on that card: the
copies, the collectives and the launches are those of a 4-device mesh,
but the devices share one card, so the numbers say what the sharded
program costs over the single-device one, not how it scales across cards.

For each mesh shape (``mesh_shapes``: data and event powers of 2, of at
most the mesh's devices) it runs ``FRAMES_PER_ROW`` frames
a data row (constant work a row: weak scaling) of the demonstrator rig
(``--camera`` / ``--projector``, ~28k events a frame, capacity 28672)
through ``parallel.make_sharded_pipeline`` on batches placed beforehand
(``shard_batches``), and, for the data-only shapes, through
``XMapsDepthEngine.process_frames_sharded`` (host staging included in
each step: the live multi-camera regime).  Every frame's result must
equal ``process_frame``'s bit for bit.  It prints ONE JSON line with the
keys of the JAX script's (``results``: ``frames_per_step``, ``step_ms``,
``frame_ms``, ``weak_scaling_eff`` a shape; ``group_live_path``), wall
times (host clock around a step + ``torch.cuda.synchronize()``, median of
``--steps``, default 20) and, on the card, device times (``device_step_ms``,
``device_frame_ms``, ``device_weak_scaling_eff``: the profiler's summed
device events a step, ``utils.profiling``; ``device_top_us``: the largest
events, us a step by name), the devices' names, whether a
device repeats (``virtual``), and the card's name and power limit.

    python -m xmaps_tpu_torch.apps.bench_scaling --virtual 4      # one card
    python -m xmaps_tpu_torch.apps.bench_scaling --device cpu --virtual 4 \\
        --camera 64 48 --projector 90 160                         # plain versions

``--out PATH`` writes the JSON line to PATH as well.  On ``--device cpu``
the times are the host's and the device times null.
Any failure raises (non-zero exit).
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import time

import numpy as np
import torch

from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine, resolve_device
from xmaps_tpu_torch.parallel import make_mesh, make_sharded_pipeline, shard_batches
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration, simulate_plane_events

#: ~28k events/frame at the demonstrator rig, and the batch capacity sized
#: to it, as apps.bench
SUBSAMPLE = 0.031
CAPACITY = 28 * 1024
#: frames a data row (constant work a row: weak scaling)
FRAMES_PER_ROW = 3
#: profiled steps a shape (device; the timed steps, whose median is the
#: wall, are ``--steps``)
PROFILE_STEPS = 10
#: device events a shape reports by name (``device_top_us``)
TOP_EVENTS = 6


def mesh_shapes(n: int) -> list:
    """The (data, event) shapes of at most ``n`` devices, both powers of 2:
    data-only first, then by event (the JAX script's seven shapes at n = 8
    among them)."""
    powers = [1 << k for k in range(n.bit_length()) if 1 << k <= n]
    return [(d, e) for e in powers for d in powers if d * e <= n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--devices", type=int, default=1,
                    help="distinct devices: cuda:0 .. cuda:N-1 (1 with --device cpu)")
    ap.add_argument("--virtual", type=int, default=1, help="times each device is listed")
    ap.add_argument("--camera", type=int, nargs=2, default=(640, 480), metavar=("W", "H"))
    ap.add_argument("--projector", type=int, nargs=2, default=(720, 1280), metavar=("W", "H"))
    ap.add_argument("--steps", type=int, default=20, help="timed steps a shape (wall: median)")
    ap.add_argument("--out", default="", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if args.steps < 1:
        raise ValueError(f"--steps {args.steps}")
    if args.devices < 1 or args.virtual < 1 or (not cuda and args.devices != 1):
        raise ValueError(f"--devices {args.devices} --virtual {args.virtual} on {args.device}")
    names = [f"cuda:{i}" if cuda else "cpu" for i in range(args.devices)
             for _ in range(args.virtual)]
    full = make_mesh(names)  # raises for a card that is not there
    devices = full.distinct

    def sync():
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)

    calib = make_synthetic_calibration(*args.camera, *args.projector)
    engine = XMapsDepthEngine.from_calibration(
        calib, device=devices[0], event_capacity=CAPACITY, z_near=0.2, z_far=1.2)
    n = len(names)
    rng = np.random.default_rng(9)
    frames = [simulate_plane_events(calib, depth_m=0.4 + 0.01 * i, subsample=SUBSAMPLE,
                                    jitter_us=2.0, rng=rng)
              for i in range(n * FRAMES_PER_ROW)]
    batches = [engine.make_batch(ev) for ev in frames]
    refs = [engine.process_frame(ev) for ev in frames]

    def check(what, outs):
        """Each frame's result equals ``process_frame``'s bit for bit."""
        for i, (got, want) in enumerate(zip(outs, refs)):
            for a, b in zip(got, want):
                if not torch.equal(a.cpu(), b.cpu()):
                    raise AssertionError(f"{what}: frame {i} differs from process_frame")
            if int(got.num_inliers) <= 0:
                raise AssertionError(f"{what}: frame {i} has no inliers")

    def timed(step):
        """(wall ms a step: median over --steps; device ms a step and its
        top device events, us a step by name: None on the CPU)."""
        step()
        sync()
        wall = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            sync()
            wall.append((time.perf_counter() - t0) * 1e3)
        if not cuda:
            return statistics.median(wall), None, None
        from xmaps_tpu_torch.utils.profiling import device_events

        by_name = collections.Counter()
        for name, _, us in device_events(step, PROFILE_STEPS, devices=devices):
            by_name[name.replace("(anonymous namespace)::", "")[:48]] += us / PROFILE_STEPS
        if not by_name:
            raise RuntimeError("torch.profiler recorded no device event")
        return (statistics.median(wall), sum(by_name.values()) / 1e3,
                dict(by_name.most_common(TOP_EVENTS)))

    def row(count, wall, device, top):
        return {"frames_per_step": count, "step_ms": wall, "frame_ms": wall / count,
                "device_step_ms": device,
                "device_frame_ms": None if device is None else device / count,
                "device_top_us": top}

    def efficiencies(results):
        base = results["1x1"]
        for v in results.values():
            v["weak_scaling_eff"] = base["frame_ms"] / v["frame_ms"]
            v["device_weak_scaling_eff"] = (None if v["device_frame_ms"] is None
                                            else base["device_frame_ms"] / v["device_frame_ms"])

    results = {}
    for data, event in mesh_shapes(n):
        mesh = make_mesh(names[:data * event], data=data, event=event)
        count = data * FRAMES_PER_ROW
        pipeline = make_sharded_pipeline(engine.cfg, engine.tables, mesh, engine.plan)
        placed = shard_batches(batches[:count], mesh, engine.cfg)
        out = pipeline(placed)
        check(f"mesh {data}x{event}", [type(out)(*(a[i] for a in out)) for i in range(count)])
        results[f"{data}x{event}"] = row(count, *timed(lambda: pipeline(placed)))
    efficiencies(results)

    live = {}
    for data, event in mesh_shapes(n):
        if event != 1:
            continue
        mesh = make_mesh(names[:data], data=data)
        block = frames[:data * FRAMES_PER_ROW]

        def step():
            return engine.process_frames_sharded(block, mesh)

        check(f"process_frames_sharded at data {data}", step())
        live[f"{data}x1"] = row(len(block), *timed(step))
    efficiencies(live)

    card = None
    if cuda:
        from xmaps_tpu_torch.apps.bench import card_name_and_power_limit

        name, limit = card_name_and_power_limit()
        card = {"name": name, "power_limit_w": limit}
    doc = {
        "metric": "weak_scaling_virtual" if full.virtual else "weak_scaling",
        "mesh_axes": ["data (frames)", "event (within-frame)"],
        "device": dev.type,
        "devices": [torch.cuda.get_device_name(d) if cuda else "cpu" for d in devices],
        "mesh_devices": [str(d) for d in full.devices.flat],
        "virtual": full.virtual,
        "card": card,
        "timing": {"wall": f"host clock + synchronize, median of {args.steps} steps",
                   "device": (f"torch.profiler, summed device events of {PROFILE_STEPS} steps"
                              if cuda else None)},
        "frames_per_row": FRAMES_PER_ROW,
        "events_per_frame": float(np.mean([min(len(ev), CAPACITY) for ev in frames])),
        "rig": {"camera": list(args.camera), "projector": list(args.projector),
                "capacity": CAPACITY},
        "results": results,
        "group_live_path": {
            "what": "engine.process_frames_sharded: each data row's frames staged on its "
                    "device and run as the process_frames program there, host staging in "
                    "each step (the live multi-camera regime)",
            "results": live,
        },
        "collectives": "event axis only: min/max of the frame time bounds, the unsigned "
                       "max of the packed maps and the sum of the inlier counts on each "
                       "row's leader, over Tensor.to copies",
    }
    line = json.dumps(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
