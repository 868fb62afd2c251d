"""Stream traffic: the app's own pipe fed event packets.

The traffic file's keys: ``loop_frames`` distinct frames re-timed at the
configuration's ``projector_fps`` (``benchmark.generator``), cut into
``packets_per_frame`` packets a projector period, as a camera delivers
them; ``source`` ``decoded`` hands the packets over as decoded arrays (a
live camera's SDK decodes), ``evt3`` writes the loop as an EVT3 recording
and replays it through the program's decoder (``FileEventsIterator``), one
pass after another, each pass's times shifted by the loop's length.
``paced`` delivers each packet when its last microsecond has passed on
the wall clock (an open loop at the projector's rate), else as soon as
the pipe returns (a closed loop).  The pipe (``DepthReprojectionPipe``,
the packet ring on) runs as ``low_latency`` says, with frame dropping off
and no image fetched.

Set-up is the program's imports, its engine and ``warmup_s`` of stream
time through the pipe, unpaced; then ``pad_s`` of traffic, the window of
``--seconds``, and ``pad_s`` more.  A frame's latency runs from when the
packet that completes its trigger was due to when the pipe has its inlier
count (``low_latency``; else when the pipe reads it, at the next frame's
dispatch).  Paced, a frame of the window the trigger finder never hands
over counts as failed; frames later than ``late_ms`` are counted on
standard error (late, not wrong).  Unpaced, the rate is the recording's frames from the first to the last frame completed
in the window, handed over or not, a second: the replay's speed times the
projector's rate (which frames the finder drops depends on the seed's
draws; how fast the recording goes through does not).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np

from benchmark import generator
from benchmark.kinds.common import (
    build_engine, kept, limits, percentile, reference_tables)
from benchmark.reference import stream as ref_stream

#: X-maps' trigger constants (trigger_finder.py:8, :98)
PAUSE_US = 40
MIN_EVENTS = 1000


class Frame:
    """One frame the trigger finder handed over."""

    __slots__ = ("k", "events", "due", "ready", "result", "inliers", "image")

    def __init__(self, k, events, due):
        self.k, self.events, self.due = k, events, due
        self.ready = self.result = self.inliers = self.image = None


def _packets(run, loop, dt):
    """(packet, its end in stream time) in stream order, without end."""
    fps = run.cfg["projector_fps"]
    if run.traffic["source"] == "decoded":
        src = generator.PacketSource(loop, fps, dt)
        j = 0
        while True:
            yield src.packet(j), (j + 1) * dt
            j += 1
    from xmaps_tpu_torch.io.event_iterator import FileEventsIterator

    path = _recording(run, loop)
    span = generator.loop_span(len(loop), fps)
    n = 0
    while True:
        for pkt in FileEventsIterator(path, delta_t=dt):
            if len(pkt):
                pkt["t"] += n * span
                yield pkt, int(pkt["t"][-1]) + 1
        n += 1


def wait(due: float):
    """Return at ``due`` (perf_counter s): sleep, then spin the last 0.5 ms."""
    while True:
        left = due - time.perf_counter()
        if left <= 0:
            return
        if left > 0.001:
            time.sleep(left - 0.0005)


def _recording(run, loop) -> str:
    """The loop as an EVT3 recording in the cache (one pass)."""
    rig, fps = run.cfg["rig"], run.cfg["projector_fps"]
    key = generator.cache_key(run.cfg, run.traffic, run.seed)
    path = os.path.join(run.cache_dir, "traffic", f"{run.cfg['name']}-{key}.raw")
    if not os.path.exists(path):
        data = generator.encode_evt3(generator.stream_events(loop, fps, 0, len(loop)),
                                     rig["camera_width"], rig["camera_height"])
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    return path


def measure(run, t_start: float) -> dict:
    import torch

    from xmaps_tpu_torch.config import RuntimeParams
    from xmaps_tpu_torch.runtime.pipe import DepthReprojectionPipe
    from xmaps_tpu_torch.utils.stats import StatsPrinter

    from benchmark.devtrace import DeviceTrace

    tr, cfg, rig = run.traffic, run.cfg, run.cfg["rig"]
    fps = cfg["projector_fps"]
    camera_view = tr["view"] == "camera"
    t0 = time.perf_counter()
    loop = generator.cached_frames(os.path.join(run.cache_dir, "traffic"), cfg, tr, run.seed)
    if tr["source"] == "evt3":
        _recording(run, loop)
    gen_s = time.perf_counter() - t0

    engine = build_engine(run, cfg["stream_event_capacity"], camera_view)
    params = RuntimeParams(
        camera_width=rig["camera_width"], camera_height=rig["camera_height"],
        projector_width=rig["projector_width"], projector_height=rig["projector_height"],
        projector_fps=fps, z_near=cfg["z_near"], z_far=cfg["z_far"], calib="",
        no_frame_dropping=True, camera_perspective=camera_view)
    frames, clock = [], {"due": None}

    def no_image(image):
        raise AssertionError("the pipe fetched an image no one wants")

    pipe = DepthReprojectionPipe(
        params, StatsPrinter(silent=True), frame_callback=no_image, engine=engine,
        low_latency=tr["low_latency"], prestage=True, frame_wanted=lambda: False)
    finder = pipe.trigger_finder
    hand_over = finder.frame_callback_indexed

    def handed_over(evs, gstart):
        f = Frame(generator.frame_of(int(evs["t"][0]), fps), evs, clock["due"])
        frames.append(f)
        with run.span("pipe.frame", f.k):
            hand_over(evs, gstart)
        if tr["low_latency"]:
            f.ready = time.perf_counter()
        elif len(frames) > 1:  # the pipe read the previous frame's count first
            frames[-2].ready = time.perf_counter()

    def issued(entry, name):
        def call(*a, **kw):
            with run.span(name, frames[-1].k if frames else None):
                res = entry(*a, **kw)
            f = frames[-1]
            f.inliers = res.num_inliers
            if kept(f.k, run.seed):
                f.result = res
            return res
        return call

    finder.frame_callback_indexed = handed_over
    engine.process_ring = issued(engine.process_ring, "engine.process_ring")
    engine.process_staged = issued(engine.process_staged, "engine.process_staged")
    pipe.ring.stage_packets = run.wrap(pipe.ring.stage_packets, "ring.stage_packets")

    dt = int(1e6 / fps / tr["packets_per_frame"])
    packets = _packets(run, loop, dt)
    warm_end = tr["warmup_s"] * 1e6
    if run.device != "cpu":
        # the window's sampled outputs, reserved in the allocator's cache
        # now so that keeping them allocates nothing in the window; the
        # reservation is left out of the peak
        frame_bytes = 4 * (rig["camera_width"] * rig["camera_height"] if camera_view
                           else rig["projector_width"] * rig["projector_height"])
        n_keep = int(run.seconds * fps / 8) + 8
        torch.empty(frame_bytes * n_keep, dtype=torch.uint8, device=run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    for pkt, end in packets:  # set-up: warm-up, unpaced
        clock["due"] = time.perf_counter()
        pipe.process_events(pkt)
        if end >= warm_end:
            break
    trace = None
    if run.trace_on:  # the profiler's start takes seconds: before the pacing
        trace = run.trace = DeviceTrace(run.device)
        trace.start()
    if run.device != "cpu":
        torch.cuda.synchronize(run.device)
    t_ready = time.perf_counter()
    run.setup_s = t_ready - t_start - gen_s
    print(f"set-up {run.setup_s:.6f} s (traffic made or loaded in {gen_s:.6f} s, "
          "not counted)", flush=True)
    pad = tr["pad_s"]
    # a traced run's window is the traced one, at most trace_s
    seconds = min(run.seconds, tr["trace_s"]) if run.trace_on else run.seconds
    w0, w1 = t_ready + pad, t_ready + pad + seconds
    run.window = (w0, w1)
    stop = w1 + pad
    marks = []
    s_ready = end
    for pkt, end in packets:
        if tr["paced"]:
            due = t_ready + (end - s_ready) / 1e6
            with run.span("pace.wait"):
                wait(due)
        else:
            due = time.perf_counter()
        if trace is not None and len(marks) < 2 and due >= (w0, w1)[len(marks)]:
            marks.append(trace.mark())
        clock["due"] = due
        with run.span("pipe.process_events"):
            pipe.process_events(pkt)
        if due >= stop:
            break
    pipe.flush()
    if frames and frames[-1].ready is None:
        frames[-1].ready = time.perf_counter()
    if run.device != "cpu":
        torch.cuda.synchronize(run.device)
    if trace is not None:
        trace.stop(marks)
    return dict(frames=frames, loop=loop, w=(w0, w1), s_ready=s_ready, t_ready=t_ready,
                seconds=seconds,
                engine=engine, pipe=pipe, e2e={}, attempted=0, failed=0)


def release(state):
    """Copy what the comparison needs to the host and free the program."""
    import torch

    for f in state["frames"]:
        if f.inliers is not None:
            f.inliers = int(f.inliers)
        if f.result is not None:
            f.image = f.result.frame_bgr.cpu().numpy()
            f.result = None
    dev = state["engine"].device
    for k in ("engine", "pipe"):
        state.pop(k)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    state["device"] = dev


def expected_frames(run, loop) -> dict:
    """Loop position -> the frame (x, y, t from its period's start) the
    reference hands over there, in the stream's steady state; a position
    it does not hand over is missing."""
    cfg = run.cfg
    fps, width = cfg["projector_fps"], cfg["rig"]["camera_width"]
    window = int(1e6 / fps)
    n = len(loop)
    generator.loop_span(n, fps)  # every pass repeats the first
    start = [generator.frame_start(k, fps) for k in range(-1, n + 1)]  # frames -1 .. n
    filt = [ref_stream.filtered_frame(_shift(loop[j - 1], start[j] - start[j + 1]), loop[j],
                                      width, window) for j in range(n)]
    parts = [_shift(filt[-1], start[0])] + [_shift(filt[j], start[j + 1]) for j in range(n)] \
        + [_shift(filt[0], start[n + 1])]
    stream = np.concatenate(parts)
    out = {}
    for a, b in ref_stream.segment(stream["t"], 1e6 / fps, PAUSE_US, MIN_EVENTS):
        ev = stream[a:b]
        j = generator.frame_of(int(ev["t"][0]), fps)
        if 0 <= j < n:
            out[j] = _shift(ev, -start[j + 1])
    return out


def _shift(ev, dt):
    ev = ev.copy()
    ev["t"] += dt
    return ev


def check(run, state, control: bool = False) -> dict:
    """The comparison with the plain reference; sets the run's attempted
    and failed frames and its end-to-end numbers."""
    import torch

    from benchmark.reference import frame as ref_frame

    tr, cfg = run.traffic, run.cfg
    loop, L = state["loop"], len(state["loop"])
    fps = cfg["projector_fps"]
    exp = expected_frames(run, loop)
    tab = reference_tables(run, state["device"])
    cap = cfg["stream_event_capacity"]
    camera_view = tr["view"] == "camera"
    (w0, w1), frames = state["w"], state["frames"]
    late = tr["late_ms"] / 1e3

    def tensors(ev):
        ev = ev[:cap]
        return [torch.from_numpy(ev[k].astype(np.int64)).to(tab.device) for k in ("x", "y", "t")]

    ref_inl, ref_img = {}, {}

    def reference(j, lower=False):
        if (j, lower) not in ref_img:
            img, inl = ref_frame.frame(tab, *tensors(exp[j]), camera_view=camera_view,
                                       z_near=cfg["z_near"], z_far=cfg["z_far"], lower=lower)
            ref_img[(j, lower)] = img.cpu().numpy()
            ref_inl[(j, lower)] = inl
        return ref_img[(j, lower)], ref_inl[(j, lower)]

    if tr["paced"]:
        s0 = state["s_ready"] + (w0 - state["t_ready"]) * 1e6
        s1 = s0 + state["seconds"] * 1e6
        # every frame whose period starts in the window is due, handed over or not
        due = set(range(generator.frame_of(math.ceil(s0) - 1, fps) + 1,
                        generator.frame_of(math.ceil(s1) - 1, fps) + 1))
        in_window = [f for f in frames if f.k in due]
        lat = [(f.ready - f.due) * 1e3 for f in in_window if f.ready is not None]
        if lat:
            print("latency ms at 10/25/50/75/90/95/99/100 %: " + " ".join(
                f"{percentile(lat, q):.4f}" for q in (10, 25, 50, 75, 90, 95, 99, 100)),
                flush=True)
        n_late = sum(1 for f in in_window if f.ready is not None and f.ready - f.due > late)
        print(f"{n_late} of {len(in_window)} frames handed over later than {tr['late_ms']} ms "
              "(late, not failed: the latency counts the wait)", flush=True)
        state["e2e"] = {"latency_p50_ms": percentile(lat, 50) if lat else None}
        # failed: due frames never handed over or never ready; which frames the
        # finder hands over follows from the events alone, so a seed fails the
        # same frames in every run
        state["attempted"] = len(due)
        state["failed"] = len(due) - len({f.k for f in in_window if f.ready is not None})
    else:
        in_window = [f for f in frames if f.ready is not None and w0 <= f.ready < w1]
        if in_window:
            lo, hi = in_window[0].k, in_window[-1].k
            due = set(range(lo, hi + 1))
        else:
            due = set()
        # the recording's frames the replay got through, handed over or not
        state["e2e"] = {"replay_frames_per_s": len(due) / state["seconds"]}
        print(f"{len(due) - len(in_window)} of the window's {len(due)} recording frames "
              "not handed over by the trigger finder", flush=True)
        # the frames handed over and completed in the window; how many of the
        # recording's frames the window takes in follows the replay's speed, so
        # the finder's drops among them are reported above and not as failed
        state["attempted"] = len(in_window)
        state["failed"] = 0

    wrong_events = inliers_off = pixels_off = compared = 0
    for f in in_window:
        j = f.k % L
        e = exp.get(j)
        ev = f.events
        if e is None or len(e) != len(ev) or not (
                np.array_equal(e["x"], ev["x"]) and np.array_equal(e["y"], ev["y"])
                and np.array_equal(e["t"], ev["t"] - generator.frame_start(f.k, fps))):
            wrong_events += 1
            continue
        img, inl = reference(j)
        got_inl = reference(j, True)[1] if control else f.inliers
        inliers_off += int(got_inl != inl)
        if f.image is not None:
            got = reference(j, True)[0] if control else f.image
            pixels_off += int(np.count_nonzero(got != img))
            compared += 1
    print(f"compared {len(in_window)} frames' events and inlier counts, {compared} frames' "
          f"images; {len(exp)} of {L} loop frames handed over by the reference", flush=True)
    return limits({"frames_wrong_events": wrong_events, "inlier_counts_off": inliers_off,
                   "pixels_off": pixels_off})
