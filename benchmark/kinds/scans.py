"""Scan traffic: ESL's depth of groups of camera scans, every plane fetched.

The traffic file's keys: ``groups`` distinct groups of ``scans_per_group``
scans, run back to back for the window, group after group, ``warmup_s`` of
calls in set-up, ``pad_s`` of calls around a traced window of at most
``trace_s``.  A scan is the time map a camera draws of one projector frame
over a plane (``benchmark.generator.plane_frame`` at the configuration's
scene, every projector pixel lit): each camera pixel holds the time of its
first event in the frame, in us since the frame's start plus 1 (a pixel lit
at the start is not empty), and 0 where the scan never reaches.  The
generator models upward scans only; ESL's projector scans each column
downwards, which is an upward scan of the projector mirrored top to
bottom, so the generator is handed that mirror (its principal point and
vertical focal length flipped).  The depths are a fixed set spread over
``depth_m``, in the seed's order.

Each call is ``ESLDepthEngine.process_scans`` of a host group, fetch on, so
it ends in the call's own synchronise.  Set-up is the program's imports,
the engine and ``warmup_s`` of calls (not the traffic's generation).
``frames_per_s`` is every scan of the window's calls over the window's
time.  Every group's first call and a sample of calls drawn from the seed
are kept and compared with the plain reference (``benchmark.reference.esl``),
pixel by pixel and bit for bit, in three counts of limit 0:
``init_pixels_off`` (disparity and depth of the init: integer disparities
and an IEEE quotient leave nothing to round), ``refined_pixels_off`` and
``filtered_pixels_off`` (the reference keeps the system's rounding points,
so a float32 run gives the same bits).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark import generator, roofline_esl
from benchmark.kinds.common import limits
from benchmark.reference import esl as ref_esl

PLANES = ("disparity_init", "depth_init", "depth_optim", "depth_optim_filtered")
#: the count each plane adds to
COUNTS = {"disparity_init": "init_pixels_off", "depth_init": "init_pixels_off",
          "depth_optim": "refined_pixels_off", "depth_optim_filtered": "filtered_pixels_off"}


def mirrored(rig: dict) -> dict:
    """The rig with its projector mirrored top to bottom: pixel y of the
    mirror is pixel H - 1 - y of the projector, so an upward scan of the
    mirror is a downward scan of the projector."""
    K = np.array(rig["projector_K"], dtype=np.float64)
    K[1, 1], K[1, 2] = -K[1, 1], rig["projector_height"] - 1 - K[1, 2]
    return {**rig, "projector_K": K.tolist()}


def scan_of(events: np.ndarray, width: int, height: int) -> np.ndarray:
    """The time map of one frame's events (sorted by time): each pixel's
    first time plus 1, 0 where no event fell (assigned latest first, so
    the first event's write is the last: NumPy's fancy assignment)."""
    pix = events["y"].astype(np.int64) * width + events["x"]
    out = np.zeros(height * width, np.float32)
    out[pix[::-1]] = events["t"][::-1] + 1
    return out.reshape(height, width)


def _widen_affinity():
    """Let a generator thread run on every core of the machine: the run's
    process is held to two (``harness.pin_cores``), generation is not
    timed, and the call changes the calling thread alone."""
    try:
        os.sched_setaffinity(0, range(os.cpu_count()))
    except OSError:
        pass


def _scan(args) -> np.ndarray:
    rig, scene, depth, frame_us, seed = args
    events = generator.plane_frame(mirrored(rig), scene, depth, frame_us,
                                   np.random.default_rng(seed))
    return scan_of(events, rig["camera_width"], rig["camera_height"])


def make_scans(cfg: dict, traffic: dict, seed: int) -> np.ndarray:
    """The traffic's ``groups`` x ``scans_per_group`` scans, (N, H, W)
    float32.  The seed orders the depths and seeds each scan's own draws,
    so the scans are made in parallel, a thread a core (NumPy lets go of
    the interpreter's lock in its loops; a scan at the ESL rig's 2M
    projector pixels takes seconds)."""
    n = traffic["groups"] * traffic["scans_per_group"]
    order, *draws = np.random.SeedSequence(seed).spawn(n + 1)
    scene = {**cfg["scene"], "scan_upwards": True}
    jobs = [(cfg["rig"], scene, float(z), int(1e6 / cfg["projector_fps"]), d)
            for z, d in zip(generator.depths(scene, n, np.random.default_rng(order)), draws)]
    with ThreadPoolExecutor(min(n, os.cpu_count() or 1), initializer=_widen_affinity) as pool:
        return np.stack(list(pool.map(_scan, jobs)))


def build_engine(run):
    """The program's ESL engine of the run's rig and settings, its maps
    cached in the checkout; its build steps go to standard error."""
    from xmaps_tpu_torch.calib.maps import CalibrationParams
    from xmaps_tpu_torch.models.esl_pipeline import ESLDepthEngine

    rig, cfg = run.cfg["rig"], run.cfg
    calib = CalibrationParams(
        camera_width=rig["camera_width"], camera_height=rig["camera_height"],
        projector_width=rig["projector_width"], projector_height=rig["projector_height"],
        rect_image_width=rig["rect_width"], rect_image_height=rig["rect_height"],
        camera_K=np.array(rig["camera_K"]), camera_D=np.array(rig["camera_D"]),
        projector_K=np.array(rig["projector_K"]), projector_D=np.array(rig["projector_D"]),
        cam2proj_R=np.array(rig["cam2proj_R"]), cam2proj_T=np.array(rig["cam2proj_T"]),
    )
    eng = ESLDepthEngine.from_calibration(
        calib, run.device, window_size=cfg["refine"]["window_size"],
        refine_iters=cfg["refine"]["iters"], maps_cache_dir=os.path.join(run.cache_dir, "engine"))
    for label, s in eng.setup_timings:
        print(f"engine set-up {label}: {s:.6f} s", file=sys.stderr)
    return eng


def measure(run, t_start: float) -> dict:
    import torch

    # the program's entry first: a tree without it fails here, at once
    from xmaps_tpu_torch.models.esl_pipeline import ESLDepthEngine  # noqa: F401

    from benchmark.devtrace import DeviceTrace

    tr, cfg = run.traffic, run.cfg
    n = tr["scans_per_group"]
    t0 = time.perf_counter()
    flat = make_scans(cfg, tr, run.seed)  # made anew: a run's seed is its own
    groups = [flat[i:i + n] for i in range(0, len(flat), n)]
    gen_s = time.perf_counter() - t0

    engine = build_engine(run)
    cuda = run.device != "cpu"

    def call(i):
        return engine.process_scans(groups[i])

    for i in range(len(groups)):  # every group once, then the warm-up time
        call(i)
    i, t_warm = 0, time.perf_counter()
    while time.perf_counter() - t_warm < tr["warmup_s"]:
        call(i % len(groups))
        i += 1
    t_ready = time.perf_counter()
    run.setup_s = t_ready - t_start - gen_s
    print(f"set-up {run.setup_s:.6f} s (traffic made in {gen_s:.6f} s, not counted)",
          flush=True)

    # the calls kept for the comparison: every group's first and eight drawn
    # from the seed over the window's expected calls; their pinned host
    # blocks (a call's four planes) are reserved in the allocator's cache
    # now, so that keeping them allocates nothing in the window
    seconds = min(run.seconds, tr["trace_s"]) if run.trace_on else run.seconds
    expect = max(int(i / (t_ready - t_warm) * seconds), len(groups) + 1)
    extra = set(np.random.default_rng(run.seed).integers(len(groups), expect, 8).tolist())
    if cuda:
        block = (len(PLANES), n, *engine.shape)
        held = [torch.empty(block, pin_memory=True) for _ in range(len(groups) + 8)]
        del held
        torch.cuda.reset_peak_memory_stats(run.device)
    trace = None
    if run.trace_on:
        trace = run.trace = DeviceTrace(run.device)
        trace.start()

    def pad():
        t = time.perf_counter()
        while time.perf_counter() - t < tr["pad_s"]:
            call(0)

    pad()
    marks = [trace.mark()] if trace is not None else []
    held, calls, scans = [], 0, 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        g = calls % len(groups)
        with run.span("scans.call", g):
            res = call(g)
        if calls < len(groups) or calls in extra:
            held.append((g, res))
        calls += 1
        scans += len(groups[g])
    w1 = time.perf_counter()  # each call ended in its own synchronise
    run.window = (w0, w1)
    if trace is not None:
        marks.append(trace.mark())
        pad()
        trace.stop(marks)
    run.values.update(calls=calls, frames=scans)
    return dict(groups=groups, held=held, engine=engine, e2e={"frames_per_s": scans / (w1 - w0)},
                attempted=scans, failed=0)


def release(state):
    import torch

    state["held"] = [(g, {k: getattr(res, k).numpy().copy() for k in PLANES})
                     for g, res in state["held"]]
    dev = state.pop("engine").device
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    state["device"] = dev


def reference_tables(run) -> dict:
    """The reference's tables of the run's rig, cached in the checkout."""
    rig = run.cfg["rig"]
    key = hashlib.sha256(json.dumps(rig, sort_keys=True).encode()
                         + open(ref_esl.__file__, "rb").read()
                         + open(ref_esl.ref_calib.__file__, "rb").read()).hexdigest()[:20]
    path = os.path.join(run.cache_dir, "reference", f"{run.cfg['name']}-esl-{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    tabs = ref_esl.tables(rig)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, **tabs)
    os.replace(tmp, path)
    return tabs


def counts(got: dict, want: dict) -> dict:
    """The three counts of one scan: pixels whose bits differ, by plane."""
    out = dict.fromkeys(COUNTS.values(), 0)
    for name, count in COUNTS.items():
        a = np.ascontiguousarray(got[name], np.float32).view(np.int32)
        b = np.ascontiguousarray(want[name], np.float32).view(np.int32)
        out[count] += int(np.count_nonzero(a != b))
    return out


def check(run, state, control: bool = False) -> dict:
    cfg = run.cfg
    tabs = reference_tables(run)
    reference = ref_esl.Reference(tabs, state["device"], cfg)
    ref = {}

    def planes(g, f, lower):
        if (g, f, lower) not in ref:
            p = reference.planes(state["groups"][g][f], lower=lower)
            ref[(g, f, lower)] = {k: v.cpu().numpy() for k, v in p.items()}
        return ref[(g, f, lower)]

    total = dict.fromkeys(COUNTS.values(), 0)
    compared = 0
    for g, got in state["held"]:
        for f in range(len(state["groups"][g])):
            mine = planes(g, f, True) if control else {k: got[k][f] for k in PLANES}
            for k, v in counts(mine, planes(g, f, False)).items():
                total[k] += v
            compared += 1
    if run.trace_on:
        per = [roofline_esl.group_bytes(reference, g) for g in state["groups"]]
        run.values["bytes"] = {"esl_init": float(np.mean(per))}
    print(f"compared {compared} scans of {len(state['held'])} group calls", flush=True)
    return limits(total)
