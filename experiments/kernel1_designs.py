#!/usr/bin/env python3
"""Kernel 1 (``event_disparity_scatter`` and its group entry) designs timed
in turns on one CUDA GPU.

Run from the root of a checkout:  python3 experiments/kernel1_designs.py
(``--check``: the parity checks only, no timing)

Builds ``experiments/kernel1_designs.cu`` (the previous kernel 1 verbatim,
its ablations and the candidates the redesign weighed) with nvcc and
``-Xptxas -v`` (each design's registers a thread are printed: 32 or
fewer keep 8 blocks of 256 on an SM), makes 12 frames at two rigs (the
demonstrator: 640 x 480 camera, 720 x 1280 projector,
``chip_smoke.make_frames``, capacity 28672;
the ESL Table-2 rig of ``apps.bench_geometry.rig("esl")`` and its
``make_frames``, 27648 events a frame), stages them as the main path does
(``eng.stage_group``: one 1-word row a frame and the device counts), and in
each cell (rig x view x entry: one frame through the staged one-frame
source, the group of 12 through the staged group source):

- checks every design that computes the whole function bit-equal to the
  plain version (``event_disparity_scatter_staged_plain`` /
  ``event_disparity_scatter_staged_group_plain``), every map word and
  count, into outputs that held garbage;
- times every design in turns (each once, then each again in reverse
  order) with the L2 cache flushed before each call
  (``chip_smoke.cold_device_ms``: 50 profiled calls a turn), and back to
  back (``chip_smoke.device_ms``) in the same turns.

The designs: the previous kernel 1; the ablations (an empty cooperative
launch with and without one ``grid.sync()``, the zeroing and the barrier
only, the lanes' gathers with no ``atomicMax`` and no count, the lanes with
their ``atomicMax`` and no count); the candidates (a) inlier counts summed
in shared memory, (b) readiness flags in place of the grid barrier, (b')
zero warps in frame order beside lane warps, (c) 4 lanes a thread gathered
up front, and their combinations; and the port's shipped kernel 1 through
its wrappers.  A design whose result is not bit-equal is reported, left
out of the timing, and the script exits 1 at the end.

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

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "kernel1_designs.cu"
GROUP = 12
#: readiness flags of the candidates' scratch (zeroed once)
FLAGS = 1 << 16

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I,  # word, counts, F, cap, count, bits x/y/t
         _P, _I, _I, _P, _I, _I,  # cam LUT, cam_h, cam_w, x_map, xmap_h, xmap_w
         _I, _I, _I, _I, _I,  # camera_view, oy, ox, out_h, out_w
         _P, _P]  # maps, inlier counts
_SIGNATURES = {
    "design_previous": _ARGS + [_P],
    "design_ablation": [_I] + _ARGS + [_P, _P],
    "design_candidate": [_I] + _ARGS + [_P, _I, _U, _P],
}

ABLATIONS = {
    0: "ablation: empty cooperative launch",
    1: "ablation: empty launch + grid.sync",
    2: "ablation: zeroing + grid.sync",
    3: "ablation: + lanes, gathers only",
    4: "ablation: + lanes, atomicMax, no count",
}
CANDIDATES = {
    0: "(a) block counts",
    1: "(b) ready flags",
    2: "(c) 4 lanes up front",
    3: "(a)+(b)",
    4: "(a)+(c)",
    5: "(b)+(c)",
    6: "(a)+(b)+(c)",
    7: "(a)+(b')+(c), 4 zero warps",
    8: "(a)+(b')+(c), 2 zero warps",
    9: "(a)+(b'), 4 zero warps, 1 lane up front",
}
PREVIOUS = "previous (csrc/events.cu before the redesign)"
SHIPPED = "shipped (csrc/events.cu)"


def build() -> tuple:
    """nvcc the designs (``-Xptxas -v``) into a library under the port's
    build directory; (library, ptxas lines)."""
    from xmaps_tpu_torch.ops import _build

    flags = (*_build.NVCC_FLAGS, "-I", str(_build.CSRC))
    h = hashlib.sha256(" ".join(flags).encode() + SOURCE.read_bytes()
                       + (_build.CSRC / "common.cuh").read_bytes())
    out_dir = _build.build_dir() / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libkernel1_designs_{h.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".ptxas.txt")
    if not lib_path.exists():
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
            tmp = os.path.join(tmp_dir, "lib.so")
            cmd = [_build._find_nvcc(), "-Xptxas", "-v", *flags, "-shared", "-o", tmp,
                   str(SOURCE)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stdout}")
            log_path.write_text(proc.stdout)
            os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, log_path.read_text() if log_path.exists() else ""


def registers(ptxas: str) -> dict:
    """Kernel (mangled, shortened) -> registers a thread, from ptxas -v."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            short = re.sub(r"N\d+previous|N\d+candidate|N\d+ablation", "", name)[:90]
            out[short] = int(m.group(1))
            name = None
    return out


def rigs():
    """(name, calibration, 12 frames) of the demonstrator and the ESL rig."""
    from xmaps_tpu_torch.apps import bench_geometry
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration

    demo = make_synthetic_calibration(640, 480, 720, 1280)
    esl = bench_geometry.rig("esl")
    return (("demo", demo, cs.make_frames(demo, GROUP, 0.031)),
            ("esl", esl, bench_geometry.make_frames(esl, GROUP, cs.CAPACITY)))


class Designs:
    """Each design as fn(poison) -> (maps (F, H, W), counts (F,)) on one
    cell's staged frames; ``poison`` fills the outputs with garbage first."""

    def __init__(self, lib, eng, staged, f):
        import torch

        self.lib, self.eng, self.f = lib, eng, f
        self.kw = cs.view_kwargs(eng)[0]
        self.staged = staged
        self.layout = eng.compact_layout
        self.flags = torch.zeros(FLAGS, dtype=torch.int32, device="cuda")
        props = torch.cuda.get_device_properties(0)
        self.sink = torch.empty(props.multi_processor_count * 2048, dtype=torch.int32,
                                device="cuda")
        self.epoch = 0

    def _outputs(self, poison):
        import torch

        out_h, out_w = self.kw["out_shape"]
        if poison:
            return (torch.full((self.f, out_h, out_w), -1, dtype=torch.int32, device="cuda"),
                    torch.full((self.f,), -7, dtype=torch.int32, device="cuda"))
        return (torch.empty((self.f, out_h, out_w), dtype=torch.int32, device="cuda"),
                torch.empty((self.f,), dtype=torch.int32, device="cuda"))

    def _args(self, maps, counts):
        import torch

        t, st = self.eng.tables, self.staged
        (oy, ox), (out_h, out_w) = self.kw["window"], self.kw["out_shape"]
        group = self.f > 1
        word = st.word if group else st.word[0]
        return (word.data_ptr(), st.counts.data_ptr() if group else None, self.f,
                st.word.shape[1], 0 if group else st.host_counts[0],
                self.layout.bits_x, self.layout.bits_y, self.layout.bits_t,
                t.cam_map_packed.data_ptr(), *t.cam_map_packed.shape,
                t.x_map.data_ptr(), *t.x_map.shape,
                int(self.kw["camera_view"]), oy, ox, out_h, out_w,
                maps.data_ptr(), counts.data_ptr()), torch.cuda.current_stream().cuda_stream

    def c_entry(self, name, *head, tail=()):
        from xmaps_tpu_torch.ops import _build

        def run(poison=False):
            maps, counts = self._outputs(poison)
            args, stream = self._args(maps, counts)
            extra = tail() if callable(tail) else tail
            _build.check(name, getattr(self.lib, name)(*head, *args, *extra, stream))
            return maps, counts
        return run

    def candidate(self, variant):
        def tail():
            self.epoch += 1
            return (self.flags.data_ptr(), FLAGS, self.epoch)
        return self.c_entry("design_candidate", variant, tail=tail)

    def shipped(self, poison=False):
        import torch
        from xmaps_tpu_torch.ops.cuda_events import (
            event_disparity_scatter_staged,
            event_disparity_scatter_staged_group,
        )

        if poison:  # the wrapper's torch.empty outputs take this freed block
            out_h, out_w = self.kw["out_shape"]
            junk = torch.full((self.f * out_h * out_w + 64,), -1, dtype=torch.int32,
                              device="cuda")
            del junk
        if self.f > 1:
            r = event_disparity_scatter_staged_group(self.staged, self.layout, self.eng.tables,
                                                     **self.kw)
            return r.packed_map, r.num_inliers
        r = event_disparity_scatter_staged(self.staged.word[0], self.staged.host_counts[0],
                                           self.layout, self.eng.tables, **self.kw)
        return r.packed_map[None], r.num_inliers[None]

    def all(self):
        """name -> (fn, computes the whole function)."""
        out = {PREVIOUS: (self.c_entry("design_previous"), True)}
        for mode, name in ABLATIONS.items():
            out[name] = (self.c_entry("design_ablation", mode, tail=(self.sink.data_ptr(),)),
                         False)
        for variant, name in CANDIDATES.items():
            out[name] = (self.candidate(variant), True)
        out[SHIPPED] = (self.shipped, True)
        return out

    def plain(self):
        import torch
        from xmaps_tpu_torch.ops.cuda_events import (
            event_disparity_scatter_staged_group_plain,
            event_disparity_scatter_staged_plain,
        )

        if self.f > 1:
            r = event_disparity_scatter_staged_group_plain(self.staged, self.layout,
                                                           self.eng.tables, **self.kw)
            return r.packed_map, r.num_inliers
        r = event_disparity_scatter_staged_plain(self.staged.word[0], self.staged.host_counts[0],
                                                 self.layout, self.eng.tables, **self.kw)
        return r.packed_map[None], torch.atleast_1d(r.num_inliers)


def bound_ms(eng, counts, out_px) -> float:
    """``chip_smoke.kernel_bytes`` of the entry timed over the HBM rate:
    the staged one-frame entry (one count, passed by the host) or the
    staged group entry (each count read from the device)."""
    t = eng.tables
    tab = (t.cam_map_packed.numel() * 4, t.x_map.numel() * 2)
    if len(counts) == 1:
        name, shape = "event_disparity_scatter_staged", (counts[0], *tab, out_px)
    else:
        name, shape = "event_disparity_scatter_group", (tuple(counts), *tab, out_px)
    return cs.kernel_bytes(name, {name: shape}) / cs.HBM_BYTES_PER_S * 1e3


def main(argv=None) -> int:
    import torch

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--check", action="store_true", help="parity only, no timing")
    opts = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel1_designs: needs a CUDA GPU", file=sys.stderr)
        return 2
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.load()
    lib, ptxas = build()
    regs = registers(ptxas)
    for name, r in regs.items():
        print(f"  ptxas: {r:3d} registers  {name}", flush=True)
    cache = str(ROOT / "build" / "xmaps_tpu_torch" / "cache")
    result, bad = {}, []
    for geometry, calib, frames in rigs():
        for view in ("projector", "camera"):
            eng = XMapsDepthEngine.from_calibration(
                calib, device="cuda", event_capacity=cs.CAPACITY, z_near=cs.Z_NEAR,
                z_far=cs.Z_FAR, camera_perspective=view == "camera", xmap_cache_dir=cache)
            for entry, f in (("one frame", 1), (f"group of {GROUP}", GROUP)):
                staged = eng.stage_group(frames[:f])
                d = Designs(lib, eng, staged, f)
                runs = d.all()
                ref = d.plain()
                exact = {}
                for name, (fn, whole) in runs.items():
                    if not whole:
                        fn()
                        continue
                    got = fn(poison=True)
                    exact[name] = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, ref))
                    if not exact[name]:
                        bad.append(f"{geometry} {view} {entry}: {name}")
                torch.cuda.synchronize()
                cell = f"{geometry} | {view} | {entry}"
                out_px = ref[0][0].numel()
                bound = bound_ms(eng, staged.host_counts, out_px)
                record = dict(bound_ms=bound, events=list(staged.host_counts),
                              map=list(ref[0].shape),
                              inliers=[int(v) for v in ref[1]], exact=exact)
                if not opts.check:
                    timed = [name for name in runs if exact.get(name, True)]
                    turns = {name: [] for name in timed}
                    warm = {name: [] for name in timed}
                    for name in [*timed, *reversed(timed)]:
                        fn = runs[name][0]
                        turns[name].append(cs.cold_device_ms(fn)[0])
                        warm[name].append(cs.device_ms(fn)[0])
                    record["designs"] = {
                        name: dict(ms=sum(turns[name]) / 2, turns=turns[name],
                                   b2b_ms=sum(warm[name]) / 2) for name in timed}
                    print(f"{cell}: bound {bound:.6f} ms; ms a call, L2 flushed (turns) [back "
                          f"to back]: " + "; ".join(
                              f"{name} {r['ms']:.5f} ({r['turns'][0]:.5f}, {r['turns'][1]:.5f})"
                              f" [{r['b2b_ms']:.5f}]" for name, r in record["designs"].items())
                          + f" [{smi}]", flush=True)
                else:
                    print(f"{cell}: exact {exact} [{smi}]", flush=True)
                result[cell] = record
    print(json.dumps(dict(card=smi, registers=regs, cells=result)), flush=True)
    if bad:
        print(f"kernel1_designs: not bit-equal to the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
