"""The benchmark's traffic generator: event frames from a seed.

One general generator for every traffic file.  A frame is the event
stream one projector scan of a plane draws on the camera (the repository's
``simulate_plane_events``, copied here so the yardstick does not move with
the program): every projector pixel kept with probability ``subsample``
fires at its linear scan time, is carried to the plane's depth, into the
camera and through its distortion; the times get Gaussian jitter, are
clipped to the scan, and the scan's last event is pinned to the scan's
end.  The scene's depths are a fixed set (``depth_m`` spread over the
frames); the seed orders them and draws the subsample and the jitter, so
every seed gives the same amount of work.

A stream is a loop of ``loop_frames`` such frames, re-timed at the
configuration's ``projector_fps``: frame k of the stream is loop frame
k mod L, starting at k / fps s in whole microseconds (``frame_start``, the
camera's clock), so a 60 Hz stream's periods are 16666 and 16667 us.
``off_share`` of the ON events get an OFF event at the same
pixel 20-60 us later (inside the scan), for the polarity filter.  Groups
are ``groups`` x ``frames_per_group`` frames cut to ``events_per_frame``
by a sorted draw without replacement.  Everything made is cached under
``build/benchmark/traffic`` keyed by the seed, the configuration and the
traffic file.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from benchmark.reference.calib import distort_points, linear_time_map

EVENT_DTYPE = np.dtype([("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<i8")])


def plane_frame(rig: dict, scene: dict, depth: float, frame_us: int,
                rng: np.random.Generator) -> np.ndarray:
    """One scan's events over a plane at ``depth`` m, times in [0, scan]."""
    wp, hp = rig["projector_width"], rig["projector_height"]
    tm = linear_time_map(wp, hp)
    if not scene.get("scan_upwards", True):
        raise ValueError("only upward scans are modelled")
    xs, ys = np.meshgrid(np.arange(wp), np.arange(hp))
    xs, ys, tn = xs.ravel(), ys.ravel(), tm.ravel()
    keep = rng.random(xs.shape[0]) < scene["subsample"]
    xs, ys, tn = xs[keep], ys[keep], tn[keep]
    Kp, Kc = np.array(rig["projector_K"]), np.array(rig["camera_K"])
    pts = np.stack([(xs - Kp[0, 2]) / Kp[0, 0] * depth, (ys - Kp[1, 2]) / Kp[1, 1] * depth,
                    np.full(xs.shape[0], depth)], axis=1)
    R, T = np.array(rig["cam2proj_R"]), np.array(rig["cam2proj_T"]).reshape(3)
    cam = (pts - T) @ R
    pd = distort_points(cam[:, :2] / cam[:, 2:3], rig["camera_D"])
    u = np.rint(pd[:, 0] * Kc[0, 0] + Kc[0, 2]).astype(np.int64)
    v = np.rint(pd[:, 1] * Kc[1, 1] + Kc[1, 2]).astype(np.int64)
    inb = (u >= 0) & (u < rig["camera_width"]) & (v >= 0) & (v < rig["camera_height"])
    scan_us = frame_us * scene["scan_fraction"]
    t = tn * scan_us + rng.normal(0, scene["jitter_us"], tn.shape)
    t = np.clip(np.rint(t), 0, int(scan_us)).astype(np.int64)
    t[np.argmax(t)] = int(scan_us)
    ev = np.zeros(int(inb.sum()), dtype=EVENT_DTYPE)
    ev["x"], ev["y"], ev["p"], ev["t"] = u[inb], v[inb], 1, t[inb]
    return ev[np.argsort(ev["t"], kind="stable")]


def with_off_events(ev: np.ndarray, share: float, end_us: int,
                    rng: np.random.Generator) -> np.ndarray:
    """``ev`` with an OFF event 20-60 us after ``share`` of its events, at
    the same pixel and no later than ``end_us``."""
    pick = rng.random(len(ev)) < share
    off = ev[pick].copy()
    off["p"] = 0
    off["t"] = np.minimum(off["t"] + rng.integers(20, 61, len(off)), end_us)
    both = np.concatenate([ev, off])
    return both[np.argsort(both["t"], kind="stable")]


def depths(scene: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The fixed set of ``n`` plane depths, in the seed's order."""
    lo, hi = scene["depth_m"]
    return rng.permutation(np.linspace(lo, hi, n))


def frame_start(k: int, fps: int) -> int:
    """Stream time (us) at which frame ``k``'s scan starts: k / fps s, floored
    to the microsecond."""
    return k * 10**6 // fps


def frame_of(t: int, fps: int) -> int:
    """The frame whose period holds stream time ``t`` (us)."""
    k = t * fps // 10**6
    return k + int(frame_start(k + 1, fps) <= t)


def loop_span(n: int, fps: int) -> int:
    """The stream time (us) of a loop of ``n`` frames, which every pass
    repeats exactly."""
    if n * 10**6 % fps:
        raise ValueError(f"{n} frames at {fps} Hz are no whole number of microseconds")
    return n * 10**6 // fps


def loop_frames(cfg: dict, traffic: dict, seed: int) -> list:
    """The stream's L distinct frames, each timed from its own start."""
    rng = np.random.default_rng(seed)
    scene, frame_us = cfg["scene"], int(1e6 / cfg["projector_fps"])
    end = int(frame_us * scene["scan_fraction"])
    out = []
    for z in depths(scene, traffic["loop_frames"], rng):
        ev = plane_frame(cfg["rig"], scene, float(z), frame_us, rng)
        out.append(with_off_events(ev, traffic["off_share"], end, rng))
    return out


def group_frames(cfg: dict, traffic: dict, seed: int) -> list:
    """``groups`` lists of ``frames_per_group`` frames of at most
    ``events_per_frame`` events."""
    rng = np.random.default_rng(seed)
    n, target = traffic["frames_per_group"], traffic["events_per_frame"]
    frames = []
    for z in depths(cfg["scene"], traffic["groups"] * n, rng):
        ev = plane_frame(cfg["rig"], cfg["scene"], float(z), int(1e6 / cfg["projector_fps"]), rng)
        if len(ev) > target:
            ev = ev[np.sort(rng.choice(len(ev), size=target, replace=False))]
        frames.append(ev)
    return [frames[i:i + n] for i in range(0, len(frames), n)]


def cache_key(cfg: dict, traffic: dict, seed: int) -> str:
    h = hashlib.sha256(json.dumps([cfg, traffic, int(seed)], sort_keys=True).encode())
    h.update(open(__file__, "rb").read())
    return h.hexdigest()[:20]


def cached_frames(cache_dir: str, cfg: dict, traffic: dict, seed: int) -> list:
    """The traffic's frames (the loop, or the flat list of the groups' frames),
    from the cache or made and cached."""
    path = os.path.join(cache_dir, f"{cfg['name']}-{cache_key(cfg, traffic, seed)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return [z[f"f{i}"] for i in range(len(z.files))]
    if traffic["kind"] == "stream":
        frames = loop_frames(cfg, traffic, seed)
    else:
        frames = [f for g in group_frames(cfg, traffic, seed) for f in g]
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, **{f"f{i}": f for i, f in enumerate(frames)})
    os.replace(tmp, path)
    return frames


def stream_events(loop: list, fps: int, k0: int, k1: int) -> np.ndarray:
    """Frames k0 .. k1 - 1 of the stream in stream time."""
    parts = []
    for k in range(k0, k1):
        ev = loop[k % len(loop)].copy()
        ev["t"] += frame_start(k, fps)
        parts.append(ev)
    return np.concatenate(parts)


class PacketSource:
    """The stream in packets of ``dt`` us of stream time from time 0, as a
    camera delivers them: ``packet(j)`` holds the events in
    [j dt, (j + 1) dt)."""

    def __init__(self, loop: list, fps: int, dt: int):
        self.loop, self.fps, self.dt = loop, fps, dt
        self.starts = [np.asarray(f["t"]) for f in loop]

    def packet(self, j: int) -> np.ndarray:
        s, e = j * self.dt, (j + 1) * self.dt
        parts = []
        for k in range(frame_of(s, self.fps), frame_of(e - 1, self.fps) + 1):
            base = frame_start(k, self.fps)
            f = self.loop[k % len(self.loop)]
            t = self.starts[k % len(self.loop)]
            a, b = np.searchsorted(t, s - base), np.searchsorted(t, e - base)
            if b > a:
                ev = f[a:b].copy()
                ev["t"] += base
                parts.append(ev)
        return np.concatenate(parts) if parts else np.zeros(0, EVENT_DTYPE)


def encode_evt3(ev: np.ndarray, width: int, height: int) -> bytes:
    """A Prophesee RAW file with an EVT3 payload: TIME_HIGH and TIME_LOW
    where the time changes, ADDR_Y where the row changes, one ADDR_X an
    event (no vector words)."""
    header = (f"% camera_integrator_name Prophesee\n% format EVT3;height={height};width={width}\n"
              f"% geometry {width}x{height}\n% end\n")
    t = ev["t"].astype(np.int64)
    y = ev["y"].astype(np.int64)
    th = t >> 12
    first = np.zeros(len(t), bool)
    first[:1] = True
    new_th = first | np.r_[False, th[1:] != th[:-1]]
    new_tl = new_th | np.r_[False, t[1:] != t[:-1]]
    new_y = first | np.r_[False, y[1:] != y[:-1]]
    n = 1 + new_th.astype(np.int64) + new_tl + new_y
    end = np.cumsum(n)
    pos = end - n
    words = np.zeros(int(end[-1]) if len(end) else 0, dtype="<u2")
    words[pos[new_th]] = (0x8 << 12) | (th[new_th] & 0xFFF)
    pos = pos + new_th
    words[pos[new_tl]] = (0x6 << 12) | (t[new_tl] & 0xFFF)
    pos = pos + new_tl
    words[pos[new_y]] = y[new_y] & 0x7FF
    pos = pos + new_y
    words[pos] = (0x2 << 12) | ((ev["p"].astype(np.int64) & 1) << 11) | (ev["x"].astype(np.int64) & 0x7FF)
    return header.encode() + words.tobytes()
