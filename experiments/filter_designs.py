#!/usr/bin/env python3
"""Kernel F (``frame_dedup_filter`` and its group entry) designs timed in
turns on one CUDA GPU: the port's kernel against the cluster design.

Run from the root of a checkout:  python3 experiments/filter_designs.py
(``--check``: the parity checks only, no timing)

Builds ``experiments/filter_designs.cu`` with nvcc and ``-Xptxas -v``
(each kernel's registers and spills are printed) once for each
``VARIANTS`` build of the cluster design (THREADS, CLUSTER: 512 x 16,
1024 x 16, 512 x 8), all at once.  It includes the port's
``csrc/filters.cu`` (``port_copy``: its kernel in namespace ``port``, its
C entries cut off) and ``experiments/filter_clusters.cu`` (the cluster
design, a copy that can stop early: ``STOPS``).  It makes 12 frames at two
rigs (the demonstrator: 640 x 480 camera, 720 x 1280 projector,
``chip_smoke.make_frames``, capacity 28672; the ESL Table-2 rig of
``apps.bench_geometry.rig("esl")`` and its ``make_frames``), stacks them
as a filtered group is (``EventBatch.stack_structured``), and in each cell:

- one frame (frame 0): the four dedup filters x both rigs x int32 and
  float32 time; the group of 12: ``first_per_xy`` at the demonstrator
  (the main path's filtered group) and ``first_per_yt`` at both rigs;
- the designs: the port's kernel through its C entry and through its
  wrapper (``apply_frame_filter``); the cluster design at the parts of
  ``cluster_plan`` (8 a frame for one frame, 1 for a group of 8 or more),
  at one part a frame, at the plan's parts with the bitmap in global
  memory, at 2 and 4 parts where the plan has more, and the other builds
  at the plan's parts (a launch the card refuses, its clusters not all
  resident, is reported and left out);
- checks every design that computes the whole function equal to the
  port's kernel (keep mask, time and priority, into outputs that held
  garbage) and the port's kernel to the plain version's contract (keep
  and time exact, the priority each survivor's rank by the plain
  priority);
- times every design in turns (each once, then each again in reverse
  order) with the L2 cache flushed before each call (one profiled session
  of ``ITERS`` calls a turn, the flush's kernels left out of the sum).

The split of both designs' time (``first_per_xy`` and ``first_per_yt`` at
the demonstrator, ``first_per_yt`` at the ESL rig, int time, one frame and
the group), in the same turns: the port's kernel's ablations (an empty
cooperative launch, the same with its three grid barriers, pass 1 alone,
passes 1-2, passes 1-3); the cluster launch empty and with four cluster
barriers; and the cluster design stopped after its keys, after each of its
first three barriers and after its flags (on a scratch of its own).

Prints the card, the build's register counts, one line a cell and one JSON
line; exits 1 on a mismatch, 2 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "filter_designs.cu"
#: the files ``build`` writes for SOURCE to include: the port's kernel and
#: the cluster design's copy.  No file beside SOURCE may have these names,
#: since a quoted include looks there before the -I directory.
PORT_INCLUDE = "filters_port.cu"
CLUSTER_INCLUDE = "filter_clusters_build.cu"
GROUP = 12
ITERS = 30
DEDUP = ("first_per_yt", "first_per_xy", "last_per_xy", "mean_first_last_per_xy")
#: the cells whose time is split (rig, filter), int time, one frame and the group
SPLIT = (("demo", "first_per_xy"), ("demo", "first_per_yt"), ("esl", "first_per_yt"))

_P, _I = ctypes.c_void_p, ctypes.c_int
_LANES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I]
_OUT = [_P, _P, _P, _P, _P, _P]  # zeroed, work, keep, t, priority, stream
_SIGNATURES = {
    "design_port": _LANES + _OUT,
    "design_port_ablation": [_I] + _LANES + _OUT,
    "design_cluster": _LANES + [_I, _I, ctypes.c_uint, _P] + _OUT,
    "design_cluster_ablation": [_I, _I, _I, _P],
    "design_set_stop": [_I],
}
PORT_ABLATIONS = {
    0: "ablation: empty cooperative launch",
    1: "ablation: + three grid.sync",
    2: "ablation: pass 1",
    3: "ablation: passes 1-2",
    4: "ablation: passes 1-3",
}
PORT = "port (csrc/filters.cu)"
WRAPPER = "port through its wrapper"
CLUSTERS = "clusters, the plan's parts"

#: the cluster design's launch constants, as experiments/filter_clusters.cu
#: has them: threads a block, blocks a cluster, lanes a cluster holds in
#: registers, the shared memory a block may have, and the head of a
#: block's shared memory before its bitmap words (8 B a word)
CLUSTER_THREADS = 512
CLUSTER_BLOCKS = 16
CLUSTER_LANES = 32768
CLUSTER_MAX_SMEM = 232448
CLUSTER_SMALL_BYTES = 336
#: the blocks a launch of few frames spreads over, about one a streaming
#: multiprocessor of the H100 (132): a frame is cut into parts, one
#: cluster each, until its frames' clusters fill them
CLUSTER_TARGET_BLOCKS = 128
#: frames a launch takes (the port's MAX_GROUP_FRAMES)
MAX_FRAMES = 2048


class ClusterPlan(NamedTuple):
    """The cluster design's launch over ``frames`` frames
    (``cluster_plan``)."""

    #: clusters a frame, each owning a part of its slots
    parts: int
    #: frames x parts x blocks a cluster
    blocks: int
    #: steps of blocks a cluster x threads lanes a frame walks past the
    #: held ones
    steps: int
    #: "shared": each part's survivor bitmap in its cluster's shared
    #: memory; "global": in the zeroed scratch (a key space too large)
    bitmap: str
    #: dynamic shared memory a block, bytes
    smem_bytes: int


def cluster_plan(frames: int, n: int, n_keys: int, name: str) -> ClusterPlan:
    """The cluster design's launch for ``frames`` frames of ``n`` lanes
    over ``n_keys`` keys with the dedup filter ``name``.  Each frame's
    size = n_keys + 1 slots are cut into ``parts`` (as many as fill
    ``CLUSTER_TARGET_BLOCKS`` with the launch's clusters, at least one),
    one cluster each.  A part's bitmap, two halves of ceil(its slots / 32)
    words (raw keys below 0, then the others), is split over its cluster's
    blocks at 8 B a word; it stays in shared memory where a block's share
    fits ``CLUSTER_MAX_SMEM``, else it goes to the zeroed scratch.  Raises
    ValueError on what the design does not take."""
    if name not in DEDUP:
        raise ValueError(f"cluster design: no kernel for the filter {name!r}")
    if not 1 <= frames <= MAX_FRAMES:
        raise ValueError(f"cluster design: {frames} frames, not 1..{MAX_FRAMES}")
    if n < 1:
        raise ValueError(f"cluster design: {n} lanes a frame")
    if not 0 < n_keys <= 1 << 29:
        raise ValueError(f"cluster design: {n_keys} keys, not 1..{1 << 29}")
    parts = max(1, CLUSTER_TARGET_BLOCKS // (CLUSTER_BLOCKS * frames))
    words = 2 * -(-(-(-(n_keys + 1) // parts)) // 32)
    block_words = -(-words // CLUSTER_BLOCKS)
    shared = CLUSTER_SMALL_BYTES + 8 * block_words <= CLUSTER_MAX_SMEM
    return ClusterPlan(
        parts=parts, blocks=frames * parts * CLUSTER_BLOCKS,
        steps=-(-max(n - CLUSTER_LANES, 0) // (CLUSTER_BLOCKS * CLUSTER_THREADS)),
        bitmap="shared" if shared else "global",
        smem_bytes=CLUSTER_SMALL_BYTES + (8 * block_words if shared else 0))


CLUSTER_SOURCE = Path(__file__).resolve().parent / "filter_clusters.cu"


#: where the cluster design may stop early (``design_set_stop``): after
#: its keys, after each of its first three cluster barriers, after pass
#: 4's bases (the flags); the statement each stop follows
STOPS = {
    0: "  F.keys(first, STRIDE, held);\n",
    1: "  cluster.sync();\n\n  // 2.",
    2: "  cluster.sync();\n\n  // 3.",
    3: "  cluster_wait();\n\n  // 4.",
    4: "  __syncthreads();\n  int r[K];",
}
SPLIT_NAMES = {0: "stop: keys", 1: "stop: pass 1", 2: "stop: passes 1-2",
               3: "stop: passes 1-3", 4: "stop: + the bases (flags)"}


def stoppable(src: str) -> str:
    """The cluster design's source with a stop (``kernel_f_stop``, default none) after
    each point of ``STOPS``: every block of the launch returns there."""
    out = "__device__ int kernel_f_stop = -1;\n" + src
    for k, at in STOPS.items():
        if out.count(at) != 1:
            raise AssertionError(f"stop {k}: {at!r} is not once in filter_clusters.cu")
        head, tail = at.split("\n", 1)
        out = out.replace(at, f"{head}\n  if (kernel_f_stop == {k}) return;\n{tail}")
    return out


#: the cluster design's builds, (THREADS, CLUSTER); the first is
#: ``cluster_plan``'s and the one timed at other parts
VARIANTS = ((512, 16), (1024, 16), (512, 8))
PLAN_VARIANT = VARIANTS[0]


def variant(src: str, threads: int, cluster: int) -> str:
    """The cluster design's source at ``threads`` threads a block and ``cluster``
    blocks a cluster (its lanes a thread follow: LANES / (CLUSTER x
    THREADS))."""
    for old, new in (("constexpr int THREADS = 512;", f"constexpr int THREADS = {threads};"),
                     ("constexpr int CLUSTER = 16;", f"constexpr int CLUSTER = {cluster};"),
                     ("int warp_sums[16];", f"int warp_sums[{threads // 32}];")):
        if src.count(old) != 1:
            raise AssertionError(f"{old!r} is not once in filter_clusters.cu")
        src = src.replace(old, new)
    return src


def port_copy(src: str) -> str:
    """The port's csrc/filters.cu with its kernel (the anonymous namespace
    after its includes) in namespace ``port`` and its C entries cut off,
    for filter_designs.cu to include beside the cluster design."""
    head, body = src.split("\nnamespace {\n", 1)
    body = body[:body.index('\nextern "C"')]
    return f"{head}\nnamespace port {{\nnamespace {{\n{body}\n}}  // namespace port\n"


def build() -> tuple:
    """nvcc the designs (``-Xptxas -v``) into a library under the port's
    build directory for each of ``VARIANTS`` of the cluster design, made
    stoppable, all at once; ({variant: library}, ptxas lines)."""
    from xmaps_tpu_torch.ops import _build

    flags = tuple(_build.NVCC_FLAGS)
    out_dir = _build.build_dir() / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    port = port_copy((_build.CSRC / "filters.cu").read_text())
    srcs = {v: stoppable(variant(CLUSTER_SOURCE.read_text(), *v)) for v in VARIANTS}
    paths = {}
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        procs = {}
        for t, src in srcs.items():
            h = hashlib.sha256(" ".join(flags).encode() + SOURCE.read_bytes() + port.encode()
                               + src.encode())
            paths[t] = out_dir / f"libfilter_designs_{h.hexdigest()[:16]}.so"
            if paths[t].exists():
                continue
            inc = Path(tmp_dir, "x".join(map(str, t)))
            inc.mkdir()
            (inc / PORT_INCLUDE).write_text(port)
            (inc / CLUSTER_INCLUDE).write_text(src)
            cmd = [_build._find_nvcc(), "-Xptxas", "-v", *flags, "-I", str(inc), "-shared",
                   "-o", str(inc / "lib.so"), str(SOURCE)]
            procs[t] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
        for t, (cmd, proc) in procs.items():
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            paths[t].with_suffix(".ptxas.txt").write_text(out)
            os.replace(Path(tmp_dir, "x".join(map(str, t)), "lib.so"), paths[t])
    libs, ptxas = {}, ""
    for t, path in paths.items():
        lib = libs[t] = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        log = path.with_suffix(".ptxas.txt")
        if log.exists():
            tag = "frame_dedup_filter_kernel_{}x{}".format(*t)
            ptxas += log.read_text().replace("frame_dedup_filter_kernel", tag)
    return libs, ptxas


def registers(ptxas: str) -> dict:
    """Kernel (mangled, shortened) -> (registers a thread, spill stores),
    from ptxas -v."""
    out, name, spill = {}, None, 0
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[re.sub(r"_GLOBAL__N__\w+?_", "", name)[:80]] = (int(m.group(1)), spill)
            name = None
    return out


def rigs():
    """(name, projector-view engine, 12 frames) of the demonstrator and
    the ESL rig."""
    from xmaps_tpu_torch.apps import bench_geometry
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration

    demo = make_synthetic_calibration(640, 480, 720, 1280)
    esl = bench_geometry.rig("esl")
    cache = str(ROOT / "build" / "xmaps_tpu_torch" / "cache")
    out = []
    for name, calib, frames in (
            ("demo", demo, cs.make_frames(demo, GROUP, 0.031)),
            ("esl", esl, bench_geometry.make_frames(esl, GROUP, cs.CAPACITY))):
        eng = XMapsDepthEngine.from_calibration(
            calib, device="cuda", event_capacity=cs.CAPACITY, z_near=cs.Z_NEAR,
            z_far=cs.Z_FAR, xmap_cache_dir=cache)
        out.append((name, eng, frames))
    return out


class Cell:
    """One cell's lanes (frames, capacity) on the card and its designs,
    each fn(poison) -> (keep, t, priority), (frames, capacity)."""

    def __init__(self, libs, eng, batch, name):
        import torch

        self.libs, self.lib = libs, libs[PLAN_VARIANT]
        self.eng, self.batch, self.name = eng, batch, name
        cfg = eng.cfg
        self.kw = dict(camera_width=cfg.camera_width, camera_height=cfg.camera_height,
                       rect_width=cfg.rect_width)
        self.lut = eng.tables.cam_map_packed
        self.frames, self.n = batch.x.shape
        yt = name == "first_per_yt"
        self.mean = name == "mean_first_last_per_xy"
        self.key_w = cfg.rect_width if yt else cfg.camera_width
        self.n_keys = cfg.camera_height * self.key_w
        size = self.n_keys + 1
        self.words = (2 * size + 31) // 32
        maps = self.frames * size * (2 if self.mean else 1)
        z = lambda k: torch.zeros(k, dtype=torch.int32, device="cuda")  # noqa: E731
        # the port's kernel's scratch (kept zero) and work; the ablations'
        # own; the cluster designs' (kept zero), with room for a global bitmap
        self.port_zeroed = z(maps + self.frames * self.words)
        self.port_work = z(2 * self.frames * self.words + 2048)
        self.abl_zeroed = z(maps + self.frames * self.words)
        # (a part's bitmap: two halves of ceil(its slots / 32) words; at most
        # 32 parts a frame)
        self.cl_work = z(2 * self.frames * (self.words + 64))
        self.cl_zeroed = z(maps + self.frames * (self.words + 64))
        self.flags = z(4 * self.frames * 32)
        self.epoch = 0
        b = batch
        self.lanes = (b.x.data_ptr(), b.y.data_ptr(), b.p.data_ptr(), b.valid.data_ptr(),
                      b.t.data_ptr(), int(b.t.dtype == torch.float32), self.frames, self.n,
                      DEDUP.index(name) + 1, self.key_w, self.n_keys,
                      *((self.lut.data_ptr(), *self.lut.shape) if yt else (None, 0, 0)))
        self.out = self._outputs(False)

    def _outputs(self, poison):
        import torch

        shape = tuple(self.batch.x.shape)
        if poison:
            return (torch.ones(shape, dtype=torch.bool, device="cuda"),
                    torch.full_like(self.batch.t, 7),
                    torch.full(shape, -5, dtype=torch.int32, device="cuda"))
        return (torch.empty(shape, dtype=torch.bool, device="cuda"),
                torch.empty_like(self.batch.t),
                torch.empty(shape, dtype=torch.int32, device="cuda"))

    def _c(self, entry, head, tail, zeroed, work, lib=None):
        """The C entry ``entry`` of ``lib`` (default: the plan's build of the
        cluster design) (head args, the lanes, tail args, the scratch and the
        outputs)."""
        import torch
        from xmaps_tpu_torch.ops import _build

        lib = lib or self.lib

        def run(poison=False):
            keep, t, prio = self._outputs(True) if poison else self.out
            args = (*head, *self.lanes, *(tail() if callable(tail) else tail))
            _build.check(entry, getattr(lib, entry)(
                *args, zeroed.data_ptr(), work.data_ptr(), keep.data_ptr(),
                t.data_ptr() if self.mean else None, prio.data_ptr(),
                torch.cuda.current_stream().cuda_stream))
            return keep, (t if self.mean else self.batch.t), prio
        return run

    def wrapper(self, poison=False):
        """The port's kernel through ``apply_frame_filter`` (one frame) or
        ``apply_frame_filter_group``."""
        import torch
        from xmaps_tpu_torch.ops.filters import apply_frame_filter, apply_frame_filter_group

        if poison:  # the wrapper's torch.empty outputs take this freed block
            junk = torch.full((self.frames * self.n * 16 + 64,), -1, dtype=torch.int32,
                              device="cuda")
            del junk
        if self.frames > 1:
            r = apply_frame_filter_group(self.batch, None, name=self.name, cam_lut=self.lut,
                                         **self.kw)
            return r.batch.valid, r.batch.t, r.scatter_priority
        r = apply_frame_filter(self.batch.frame(0), None, name=self.name, cam_lut=self.lut,
                               **self.kw)
        return r.batch.valid[None], r.batch.t[None], r.scatter_priority[None]

    def cluster(self, parts, global_bits, build=PLAN_VARIANT):
        """The cluster design through its C entry of the ``build`` (THREADS,
        CLUSTER), ``parts`` clusters a frame, a new epoch every call."""
        def tail():
            return (parts, global_bits, self.next_epoch(), self.flags.data_ptr())
        return self._c("design_cluster", (), tail, self.cl_zeroed, self.cl_work,
                       self.libs[build])

    def stopped(self, stop, parts):
        """The cluster design through its C entry, stopped at ``stop``
        (``STOPS``), on a scratch of its own (left as the stop leaves it)."""
        import torch
        from xmaps_tpu_torch.ops import _build

        run = self._c("design_cluster", (), lambda: (parts, 0, self.next_epoch(),
                                                     self.flags.data_ptr()),
                      self.abl_zeroed, self.cl_work)

        def call(poison=False):
            _build.check("design_set_stop", self.lib.design_set_stop(stop))
            try:
                return run(poison)
            finally:
                torch.cuda.synchronize()
                _build.check("design_set_stop", self.lib.design_set_stop(-1))
        return call

    def next_epoch(self):
        """A new epoch for a launch on ``flags``, never 0; at the wrap of
        its 32 bits the flags are cleared first, so no flag holds an epoch
        of a later launch."""
        if self.epoch == 2**32 - 1:
            self.flags.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch

    def cluster_ablation(self, mode):
        import torch
        from xmaps_tpu_torch.ops import _build

        plan = self.plan()

        def run(poison=False):
            _build.check("design_cluster_ablation", self.lib.design_cluster_ablation(
                mode, self.frames * plan.parts, plan.smem_bytes,
                torch.cuda.current_stream().cuda_stream))
        return run

    def plan(self):
        return cluster_plan(self.frames, self.n, self.n_keys, self.name)

    def designs(self, split):
        """name -> (fn, computes the whole function)."""
        out = {PORT: (self._c("design_port", (), (), self.port_zeroed, self.port_work), True),
               WRAPPER: (self.wrapper, True)}
        plan = self.plan()
        out[CLUSTERS] = (self.cluster(plan.parts, 0), True)
        if plan.parts > 1:
            out["one part a frame"] = (self.cluster(1, 0), True)
        out[f"{plan.parts} parts, global bitmap"] = (self.cluster(plan.parts, 1), True)
        for parts in (2, 4):  # fewer parts a frame than the plan's
            if parts < plan.parts:
                out[f"{parts} parts"] = (self.cluster(parts, 0), True)
        for build in VARIANTS[1:]:  # refused where not all resident
            out["{} parts, {} threads, cluster {}".format(plan.parts, *build)] = (
                self.cluster(plan.parts, 0, build), True)
        if split:
            for mode, name in PORT_ABLATIONS.items():
                out[name] = (self._c("design_port_ablation", (mode,), (), self.abl_zeroed,
                                     self.port_work), False)
            out["ablation: empty cluster launch"] = (self.cluster_ablation(0), False)
            out["ablation: + four cluster.sync"] = (self.cluster_ablation(1), False)
            for stop, name in SPLIT_NAMES.items():
                out[name] = (self.stopped(stop, plan.parts), False)
        return out

    def plain_contract(self, got):
        """The port's kernel's outputs against the plain version: keep and
        t exact, the priority each survivor's rank by the plain priority."""
        import torch
        from xmaps_tpu_torch.ops.filters import apply_frame_filter_plain, lut_rectified_x

        for f in range(self.frames):
            b = self.batch.frame(f)
            xr = lut_rectified_x(b.x, b.y, self.lut) if self.name == "first_per_yt" else None
            want = apply_frame_filter_plain(b, xr, name=self.name, **self.kw)
            keep = want.batch.valid
            if not (torch.equal(got[0][f], keep) and torch.equal(got[1][f], want.batch.t)
                    and torch.equal(got[2][f], cs.survivor_rank(want.scatter_priority, keep))):
                return False
        return True


def bound_ms(cell) -> float:
    """``chip_smoke.kernel_bytes`` of the cell over the HBM rate."""
    b = cell.batch
    pos = (b.valid & (b.p == 1)).sum(1).tolist()
    lut_b = cell.lut.numel() * 4 if cell.name == "first_per_yt" else 0
    shape = [(cell.n, p, lut_b, cell.mean) for p in pos]
    return cs.kernel_bytes("frame_dedup_filter", {"frame_dedup_filter": shape}) \
        / cs.HBM_BYTES_PER_S * 1e3


def cold_ms(fn) -> float:
    """Device ms a call of ``fn`` with the L2 cache flushed before each
    call: one profiled session of ``ITERS`` (flush, call) pairs, the
    flush's device events (``chip_smoke.l2_flush``) left out of the sum."""
    buf, flush = cs.l2_flush()

    def call():
        buf.bitwise_not_()
        fn()

    _, by_name = cs.profile_calls(call, ITERS)
    own = {k: v for k, v in by_name.items() if k not in flush}
    if not own:
        raise AssertionError("no device event of the call apart from the flush's")
    return sum(own.values())


def split(designs: dict) -> dict:
    """The port's kernel's time split by its ablations (ms a call), and
    the cluster design's launch, barrier and stops."""
    a = [designs[PORT_ABLATIONS[m]]["ms"] for m in range(5)]
    full = designs[PORT]["ms"]
    barrier = (a[1] - a[0]) / 3
    return dict(launch=a[0], grid_barrier=barrier, pass1=a[2] - a[0],
                pass2=a[3] - a[2] - barrier, pass3=a[4] - a[3] - barrier,
                pass4=full - a[4] - barrier,
                **{SPLIT_NAMES[k]: designs[SPLIT_NAMES[k]]["ms"] for k in SPLIT_NAMES},
                cluster_launch=designs["ablation: empty cluster launch"]["ms"],
                cluster_barrier=(designs["ablation: + four cluster.sync"]["ms"]
                                 - designs["ablation: empty cluster launch"]["ms"]) / 4)


def main(argv=None) -> int:
    import torch

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--check", action="store_true", help="parity only, no timing")
    opts = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("filter_designs: needs a CUDA GPU", file=sys.stderr)
        return 2
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.ops.event_batch import EventBatch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.load()
    libs, ptxas = build()
    regs = registers(ptxas)
    for name, (r, spill) in regs.items():
        print(f"  ptxas: {r:3d} registers, {spill} B spill  {name}", flush=True)
    result, bad = {}, []
    for rig, eng, frames in rigs():
        stacked = EventBatch.stack_structured(frames, cs.CAPACITY, device="cuda")
        cells = [(name, float_t, 1) for name in DEDUP for float_t in (False, True)]
        cells += [(name, False, GROUP) for name in ("first_per_xy", "first_per_yt")
                  if rig == "demo" or name == "first_per_yt"]
        for name, float_t, f in cells:
            batch = EventBatch(*(a[:f] for a in stacked[:5]), count=stacked.count[:f])
            if float_t:
                batch = batch._replace(t=batch.t.float())
            cell = Cell(libs, eng, batch, name)
            runs = cell.designs(split=not float_t and (rig, name) in SPLIT)
            ref = runs[PORT][0](poison=True)
            exact, refused = {PORT: cell.plain_contract(ref)}, []
            for dname, (fn, whole) in list(runs.items()):
                if dname == PORT:
                    continue
                try:
                    got = fn(poison=True)
                except RuntimeError as e:  # a launch the card refuses: not timed
                    if dname in (WRAPPER, CLUSTERS):
                        raise
                    refused.append(f"{dname}: {e}")
                    del runs[dname]
                    continue
                if whole:
                    exact[dname] = all(torch.equal(a, b) for a, b in zip(got, ref))
            torch.cuda.synchronize()
            bad += [f"{rig} {name} {'f32' if float_t else 'i32'} t, {f} frame(s): {d}"
                    for d, ok in exact.items() if not ok]
            key = f"{rig} | {name} | {'float' if float_t else 'int'} t | {f} frame(s)"
            record = dict(bound_ms=bound_ms(cell), survivors=int(ref[0].sum()), exact=exact,
                          refused=refused)
            if not opts.check:
                timed = [d for d in runs if exact.get(d, True)]
                turns = {d: [] for d in timed}
                for d in [*timed, *reversed(timed)]:
                    turns[d].append(cold_ms(runs[d][0]))
                record["designs"] = {d: dict(ms=sum(t) / 2, turns=t) for d, t in turns.items()}
                if PORT_ABLATIONS[0] in record["designs"] and PORT in record["designs"]:
                    record["split"] = split(record["designs"])
                print(f"{key}: bound {record['bound_ms']:.6f} ms; ms a call, L2 flushed "
                      f"(turns): " + "; ".join(
                          f"{d} {r['ms']:.5f} ({r['turns'][0]:.5f}, {r['turns'][1]:.5f})"
                          for d, r in record["designs"].items())
                      + (f"; split {json.dumps(record['split'])}" if "split" in record else "")
                      + (f"; refused {refused}" if refused else "")
                      + f" [{smi}]", flush=True)
            else:
                print(f"{key}: exact {exact} [{smi}]", flush=True)
            result[key] = record
    print(json.dumps(dict(card=smi, registers=regs, cells=result)), flush=True)
    if bad:
        print(f"filter_designs: not equal: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
