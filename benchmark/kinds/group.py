"""Group traffic: frames handed to the engine ``frames_per_group`` at a time.

The traffic file's keys: ``groups`` distinct groups of ``frames_per_group``
frames of at most ``events_per_frame`` events (``benchmark.generator``), in
the ``view`` (``projector`` or ``camera``), run back to back for the window,
group after group, and the window closed by one synchronise.  ``resident``:
the groups are staged on the card once in set-up
(``XMapsDepthEngine.stage_group``) and each call is the program's group
program on them (``ops.frame_pipeline.group_depth_frames``, display-packed:
what ``process_frames`` runs after its staging); otherwise each call is
``XMapsDepthEngine.process_frames`` of the host frames (staging included),
display-packed.  Set-up is the program's imports, the engine, and
``warmup_s`` of calls.  ``frames_per_s`` is every frame of the window's
calls over the window's time, the final synchronise included.
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark import generator, roofline
from benchmark.kinds.common import build_engine, limits, reference_tables


def measure(run, t_start: float) -> dict:
    import torch

    from xmaps_tpu_torch.ops.frame_pipeline import group_depth_frames

    from benchmark.devtrace import DeviceTrace

    tr, cfg = run.traffic, run.cfg
    n = tr["frames_per_group"]
    t0 = time.perf_counter()
    flat = generator.cached_frames(os.path.join(run.cache_dir, "traffic"), cfg, tr, run.seed)
    groups = [flat[i:i + n] for i in range(0, len(flat), n)]
    gen_s = time.perf_counter() - t0

    engine = build_engine(run, cfg["group_event_capacity"], tr["view"] == "camera")
    cuda = run.device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize(run.device)

    engine.stage_group = run.wrap(engine.stage_group, "engine.stage_group")
    if tr["resident"]:
        staged = [engine.stage_group(g) for g in groups]

        def call(i):
            return group_depth_frames(staged[i], engine.tables, engine.cfg, engine.plan,
                                      layout=engine.compact_layout, display_only=True,
                                      display_packed=True)
    else:
        def call(i):
            return engine.process_frames(groups[i], display_only=True, display_packed=True)

    def timed_call(i):
        with run.span("group.call", i):
            return call(i)

    for i in range(len(groups)):  # every group once, then the warm-up time
        call(i)
    sync()
    i, t_warm = 0, time.perf_counter()
    while time.perf_counter() - t_warm < tr["warmup_s"]:
        call(i % len(groups))
        i += 1
    sync()
    t_ready = time.perf_counter()
    run.setup_s = t_ready - t_start - gen_s
    print(f"set-up {run.setup_s:.6f} s (traffic made or loaded in {gen_s:.6f} s, not counted)",
          flush=True)

    # the outputs kept for the comparison: every group's first call and
    # eight calls drawn from the seed over the window's expected calls,
    # reserved in the allocator's cache now so keeping them allocates
    # nothing in the window
    seconds = min(run.seconds, tr["trace_s"]) if run.trace_on else run.seconds
    expect = max(int(i / (t_ready - t_warm) * seconds), len(groups) + 1)
    extra = set(np.random.default_rng(run.seed).integers(len(groups), expect, 8).tolist())
    if cuda:
        out = call(0)
        out_bytes = sum(r.frame_bgr.numel() * r.frame_bgr.element_size()
                        for r in (out if isinstance(out, list) else [out]))
        del out
        torch.empty((len(groups) + 8) * out_bytes, dtype=torch.uint8, device=run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    trace = None
    if run.trace_on:
        trace = run.trace = DeviceTrace(run.device)
        trace.start()

    def pad():
        t = time.perf_counter()
        while time.perf_counter() - t < tr["pad_s"]:
            call(0)
        sync()

    pad()
    marks = [trace.mark()] if trace is not None else []
    held, calls, frames = [], 0, 0
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        g = calls % len(groups)
        res = timed_call(g)
        if calls < len(groups) or calls in extra:
            held.append((g, res))
        calls += 1
        frames += len(groups[g])
    sync()
    w1 = time.perf_counter()
    run.window = (w0, w1)
    if trace is not None:
        marks.append(trace.mark())
        pad()
        trace.stop(marks)
    run.values.update(calls=calls, frames=frames)
    return dict(groups=groups, held=held, engine=engine, e2e={"frames_per_s": frames / (w1 - w0)},
                attempted=frames, failed=0, capacity=cfg["group_event_capacity"])


def release(state):
    import torch

    def host(res):  # a group's FrameResult, or process_frames' list of them
        if isinstance(res, list):
            return (np.stack([r.frame_bgr.cpu().numpy() for r in res]),
                    np.array([int(r.num_inliers) for r in res]))
        return res.frame_bgr.cpu().numpy(), res.num_inliers.cpu().numpy()

    state["held"] = [(g, *host(res)) for g, res in state["held"]]
    dev = state.pop("engine").device
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    state["device"] = dev


def check(run, state, control: bool = False) -> dict:
    import torch

    from benchmark.reference import frame as ref_frame

    cfg, tr = run.cfg, run.traffic
    tab = reference_tables(run, state["device"])
    cap = state["capacity"]
    ref = {}

    def reference(g, f, lower):
        if (g, f, lower) not in ref:
            ev = state["groups"][g][f][:cap]
            xyz = [torch.from_numpy(ev[k].astype(np.int64)).to(tab.device) for k in ("x", "y", "t")]
            img, inl = ref_frame.frame(tab, *xyz, camera_view=tr["view"] == "camera",
                                       z_near=cfg["z_near"], z_far=cfg["z_far"], lower=lower)
            ref[(g, f, lower)] = (img.cpu().numpy(), inl)
        return ref[(g, f, lower)]

    inliers_off = pixels_off = compared = 0
    for g, images, inliers in state["held"]:
        for f in range(len(images)):
            img, inl = reference(g, f, False)
            got_img, got_inl = reference(g, f, True) if control else (images[f], int(inliers[f]))
            inliers_off += int(got_inl != inl)
            pixels_off += int(np.count_nonzero(got_img != img))
            compared += 1
    if run.trace_on:
        per = [roofline.group_bytes(tab, g, cap, tr["view"] == "camera") for g in state["groups"]]
        run.values["bytes"] = {k: float(np.mean([b[k] for b in per])) for k in per[0]}
    print(f"compared {compared} frames of {len(state['held'])} group calls", flush=True)
    return limits({"inlier_counts_off": inliers_off, "pixels_off": pixels_off})
