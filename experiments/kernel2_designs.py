#!/usr/bin/env python3
"""Kernel 2 (``tail_projector`` and its group entry) designs timed in turns
on one CUDA GPU.

Run from the root of a checkout:  python3 experiments/kernel2_designs.py

Builds ``experiments/kernel2_designs.cu`` (the previous kernel 2 verbatim and the
candidates the port does not ship) with nvcc, makes the packed crops of 12
frames at two rigs (``apps.bench_geometry.rig``: the demonstrator, crop
901 x 532 and projector 720 x 1280, and the ESL Table-2 rig, crop 1229 x
723 and projector 1080 x 1920; the bench's frames through kernel 1's staged
group entry), checks every design bit-equal to ``tail_projector_group_plain``
in both output variants timed (display-packed; depth + disparity + 3-byte
BGR), then times the designs in turns (each design once, then each again
in reverse order; 50 profiled calls a turn, ``chip_smoke.device_ms``) in
three entries: one frame back to back, one frame with the L2 cache flushed
before each call, and the group of 12 with the L2 cache flushed
(``chip_smoke.cold_device_ms``).  Each time is split into the dilate and
the remap pass by the profiler's kernel names.

The designs: the previous one (a 32 x 32 tile dilate, the divisions, 8 px
a thread, the frame on a grid axis), the remap through the colorize table at 8 and 4 px a thread with the
frame on a grid axis, with the maps read once a group, and with the frames
split over a small grid axis; the column-strip dilates of six shapes; the
remap with streaming stores and with two frames' gathers issued together;
and the port's shipped kernel 2 (strips 128 x 16, then the 4-px remap with
the maps read once a group and the frames two at a time) through its
wrappers.

Prints the card, one line a cell and one JSON line; exits 1 on a mismatch,
2 without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "kernel2_designs.cu"
GEOMETRIES = ("demo", "esl")
GROUP = 12

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
_HEAD = [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _L]
_OUTS = [_P, _P, _P, _P, _P]  # bgr_packed, bgr3, depth, disp, stream
_SIGNATURES = {
    "design_previous": _HEAD + [_P, _F, _F, _F] + _OUTS,
    "design_candidate": [_I, _I, _I, _I] + _HEAD + [_P, _P] + _OUTS,
}

VARIANTS = {
    "display-packed": dict(emit_aux=False, packed_bgr=True),
    "depth + disparity + 3-byte BGR": dict(emit_aux=True, packed_bgr=False),
}
#: (entry, frames, L2 flushed before each call)
ENTRIES = (("one frame", 1, False), ("one frame, L2 flushed", 1, True),
           (f"group of {GROUP}, L2 flushed", GROUP, True))
#: dilate id of design_candidate -> its name
DILATES = {0: "32x32 tile", 1: "strips 128x32", 2: "strips 128x16", 3: "strips 64x16",
           4: "strips 128x8", 5: "strips 256x16", 6: "strips 32x16"}
#: design_candidate's remap flags -> their names
FLAGS = {1: "streaming stores", 2: "frame pairs", 3: "streaming stores, frame pairs"}


def build() -> ctypes.CDLL:
    """nvcc the designs into a library under the port's build directory."""
    from xmaps_tpu_torch.ops import _build

    flags = (*_build.NVCC_FLAGS, "-I", str(_build.CSRC))
    h = hashlib.sha256(" ".join(flags).encode() + SOURCE.read_bytes()
                       + (_build.CSRC / "common.cuh").read_bytes())
    out_dir = _build.build_dir() / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libkernel2_designs_{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
            tmp = os.path.join(tmp_dir, "lib.so")
            cmd = [_build._find_nvcc(), *flags, "-shared", "-o", tmp, str(SOURCE)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stdout}")
            os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def designs(lib, tables, plan, frames):
    """Design name -> fn(packed (F, H, W), emit_aux, packed_bgr) returning
    (frame, depth, disp) with a leading frame axis."""
    import torch
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.ops.cuda_tail import (
        _group_outputs,
        tail_projector,
        tail_projector_group,
    )

    Hp, Wp = tables.proj_mapx_i16.shape
    bgr_table, depth_table = plan.table

    def c_entry(name, head, tail):
        def run(packed, emit_aux, packed_bgr):
            f = packed.shape[0]
            outs, ptrs, stride = _group_outputs(f, (Hp, Wp), packed.device, emit_aux, packed_bgr)
            dil = torch.empty(packed.shape, dtype=torch.uint16, device=packed.device)
            _build.check(name, getattr(lib, name)(
                *head, packed.data_ptr(), f, plan.H, plan.W, plan.crop_row0, plan.crop_col0,
                plan.full_H, plan.full_W, dil.data_ptr(), tables.proj_mapx_i16.data_ptr(),
                tables.proj_mapy_i16.data_ptr(), Hp, Wp, stride, *tail, *ptrs,
                torch.cuda.current_stream().cuda_stream))
            return outs
        return run

    def candidate(dilate, px, chunk, flags=0):
        return c_entry("design_candidate", (dilate, px, chunk, flags),
                       (bgr_table.data_ptr(), depth_table.data_ptr()))

    def shipped(packed, emit_aux, packed_bgr):
        if packed.shape[0] > 1:
            return tail_projector_group(packed, tables, plan, emit_aux=emit_aux,
                                        packed_bgr=packed_bgr)
        return tuple(None if a is None else a[None] for a in tail_projector(
            packed[0], tables, plan, emit_aux=emit_aux, packed_bgr=packed_bgr))

    out = {"previous (32x32 tile, divisions, 8 px, frame on grid)": c_entry(
        "design_previous", (), (tables.turbo_lut.data_ptr(), plan.p03, plan.z_near, plan.z_far))}
    if frames == 1:
        out.update({
            "table, 8 px": candidate(0, 8, 1),
            "table, 4 px": candidate(0, 4, 1),
            **{f"table, 4 px, {DILATES[d]}": candidate(d, 4, 1) for d in range(1, 7)},
            f"table, 4 px, {DILATES[2]}, {FLAGS[1]}": candidate(2, 4, 1, 1),
        })
    else:
        out.update({
            "table, 8 px, frame on grid": candidate(0, 8, 1),
            "table, 4 px, frame on grid": candidate(0, 4, 1),
            "table, 8 px, maps once": candidate(0, 8, frames),
            "table, 4 px, maps once": candidate(0, 4, frames),
            "table, 4 px, 2 frame chunks": candidate(0, 4, -(-frames // 2)),
            "table, 4 px, 4 frame chunks": candidate(0, 4, -(-frames // 4)),
            **{f"table, 4 px, maps once, {DILATES[d]}": candidate(d, 4, frames)
               for d in range(1, 7)},
            **{f"table, 4 px, maps once, {DILATES[2]}, {name}": candidate(2, 4, frames, flags)
               for flags, name in FLAGS.items()},
        })
    out["shipped (csrc/tail.cu)"] = shipped
    return out


def bound_ms(f, crop_px, proj_px, distinct, aux) -> float:
    """Bytes over the HBM rate: each crop in, each frame's outputs out
    (packed BGR, or 3-byte BGR + f32 depth + f32 disparity), the maps and
    the table entries of the distinct disparities once."""
    out_b = 11 if aux else 4
    b = f * (4 * crop_px + out_b * proj_px) + 4 * proj_px + 4 * distinct * (2 if aux else 1)
    return b / cs.HBM_BYTES_PER_S * 1e3


def split_us(by_name) -> tuple:
    """(dilate us, remap us) of a call's device events by kernel name."""
    dil = sum(v for k, v in by_name.items() if "dilate" in k)
    return round(dil * 1e3, 3), round((sum(by_name.values()) - dil) * 1e3, 3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel2_designs: needs a CUDA GPU", file=sys.stderr)
        return 2
    from xmaps_tpu_torch.apps import bench_geometry
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter_staged_group
    from xmaps_tpu_torch.ops.cuda_tail import tail_projector_group_plain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = build()
    cache = str(ROOT / "build" / "xmaps_tpu_torch" / "cache")
    result = {}
    for geometry in GEOMETRIES:
        calib = bench_geometry.rig(geometry)
        eng = XMapsDepthEngine.from_calibration(
            calib, device="cuda", event_capacity=cs.CAPACITY, z_near=cs.Z_NEAR,
            z_far=cs.Z_FAR, xmap_cache_dir=cache)
        frames = bench_geometry.make_frames(calib, GROUP, cs.CAPACITY)
        kw = cs.view_kwargs(eng)[0]
        group = event_disparity_scatter_staged_group(
            eng.stage_group(frames), eng.compact_layout, eng.tables, **kw).packed_map
        crop_px, proj_px = eng.plan.H * eng.plan.W, eng.tables.proj_mapx_i16.numel()
        for entry, f, cold in ENTRIES:
            packed = group[:f].clone()
            distinct = cs.projector_disparities(packed, eng.tables, eng.plan)
            runs = designs(lib, eng.tables, eng.plan, f)
            for variant, opts in VARIANTS.items():
                ref = tail_projector_group_plain(packed, eng.tables, eng.plan, **opts)
                for name, fn in runs.items():
                    cs.assert_exact(f"{geometry} {entry} {name} ({variant})",
                                    list(zip(fn(packed, **opts), ref)))
                timer = cs.cold_device_ms if cold else cs.device_ms
                turns = {name: [] for name in runs}
                split = {}
                for name in [*runs, *reversed(runs)]:
                    ms, _, _, by_name = timer(lambda: runs[name](packed, **opts))
                    turns[name].append(ms)
                    split.setdefault(name, split_us(by_name))
                bound = bound_ms(f, crop_px, proj_px, distinct, opts["emit_aux"])
                cell = {name: dict(ms=sum(t) / 2, turns=t, dilate_remap_us=split[name])
                        for name, t in turns.items()}
                result[f"{geometry} | {entry} | {variant}"] = dict(
                    bound_ms=bound, crop=[eng.plan.H, eng.plan.W],
                    projector=list(eng.tables.proj_mapx_i16.shape), distinct=distinct,
                    designs=cell)
                print(f"{geometry} (crop {eng.plan.H}x{eng.plan.W}, projector "
                      f"{tuple(eng.tables.proj_mapx_i16.shape)}), {entry}, {variant}: all "
                      f"bit-equal to the plain version; bound {bound:.6f} ms; ms a call (turns) "
                      f"[dilate, remap us]: " + "; ".join(
                          f"{name} {r['ms']:.5f} ({r['turns'][0]:.5f}, {r['turns'][1]:.5f}) "
                          f"{list(r['dilate_remap_us'])}" for name, r in cell.items())
                      + f" [{smi}]", flush=True)
    print(json.dumps(dict(card=smi, cells=result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
