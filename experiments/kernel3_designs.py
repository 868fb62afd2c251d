#!/usr/bin/env python3
"""Kernel 3 (``colorize_camera``) designs timed in turns on one CUDA GPU.

Run from the root of a checkout:  python3 experiments/kernel3_designs.py

Builds ``experiments/kernel3_designs.cu`` (the designs the port does not
ship) with nvcc, makes the demonstrator camera-view packed map that
``chip_smoke.py``'s phase 6 times (frame 0 of its frames through kernel 1),
checks every design bit-equal to ``colorize_camera_plain``, then times them
in turns (each design once, then each again in reverse order; 50 profiled
calls a turn, ``chip_smoke.device_ms``) in two output variants:
display-packed, and depth + disparity + 3-byte BGR.  The designs: one pixel
a thread with the epilogue's divisions (kernel 3 before the table), eight
pixels a thread with the divisions, eight through the colorize table, and
the port's kernel 3 (four pixels a thread through the table).

Prints the card, one line a variant and one JSON line; exits 1 on a
mismatch, 2 without CUDA.
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

SOURCE = Path(__file__).resolve().parent / "kernel3_designs.cu"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "design_one_px": [_P, _I, _P, _F, _F, _F, _P, _P, _P, _P, _P],
    "design_eight_px": [_I, _P, _I, _P, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P],
}

VARIANTS = {
    "display-packed": dict(emit_aux=False, packed_bgr=True),
    "depth + disparity + 3-byte BGR": dict(emit_aux=True, packed_bgr=False),
}


def build() -> ctypes.CDLL:
    """nvcc the designs into a library under the port's build directory."""
    from xmaps_tpu_torch.ops import _build

    flags = (*_build.NVCC_FLAGS, "-I", str(_build.CSRC))
    h = hashlib.sha256(" ".join(flags).encode() + SOURCE.read_bytes()
                       + (_build.CSRC / "common.cuh").read_bytes())
    out_dir = _build.build_dir() / "experiments"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libkernel3_designs_{h.hexdigest()[:16]}.so"
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


def designs(lib, packed, tables, plan):
    """Design name -> fn(emit_aux, packed_bgr) returning (frame, depth, disp)."""
    import torch
    from xmaps_tpu_torch.ops import _build
    from xmaps_tpu_torch.ops.cuda_tail import _outputs, colorize_camera

    n = plan.H * plan.W
    bgr_table, depth_table = plan.table
    lut = tables.turbo_lut

    def one_px(emit_aux, packed_bgr):
        outs, ptrs = _outputs((plan.H, plan.W), packed.device, emit_aux, packed_bgr)
        _build.check("design_one_px", lib.design_one_px(
            packed.data_ptr(), n, lut.data_ptr(), plan.p03, plan.z_near, plan.z_far,
            *ptrs, torch.cuda.current_stream().cuda_stream))
        return outs

    def eight_px(table):
        def run(emit_aux, packed_bgr):
            outs, ptrs = _outputs((plan.H, plan.W), packed.device, emit_aux, packed_bgr)
            _build.check("design_eight_px", lib.design_eight_px(
                table, packed.data_ptr(), n, lut.data_ptr(), plan.p03, plan.z_near,
                plan.z_far, bgr_table.data_ptr(), depth_table.data_ptr(), *ptrs,
                torch.cuda.current_stream().cuda_stream))
            return outs
        return run

    return {
        "1 px + divisions": one_px,
        "8 px + divisions": eight_px(0),
        "8 px + table": eight_px(1),
        "4 px + table (colorize_camera)": lambda emit_aux, packed_bgr: colorize_camera(
            packed, tables, plan, emit_aux=emit_aux, packed_bgr=packed_bgr),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel3_designs: needs a CUDA GPU", file=sys.stderr)
        return 2
    from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine
    from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter
    from xmaps_tpu_torch.ops.cuda_tail import colorize_camera_plain
    from xmaps_tpu_torch.ops.disparity import scale_time
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = build()
    calib = make_synthetic_calibration(640, 480, 720, 1280)
    eng = XMapsDepthEngine.from_calibration(
        calib, device="cuda", camera_perspective=True, event_capacity=cs.CAPACITY,
        z_near=cs.Z_NEAR, z_far=cs.Z_FAR,
        xmap_cache_dir=str(ROOT / "build" / "xmaps_tpu_torch" / "cache"))
    batch = eng.make_batch(cs.make_frames(calib, 1, 0.031)[0])
    t_bin = scale_time(batch.t, batch.valid, eng.cfg.t_px_scale)
    kw = cs.view_kwargs(eng)[0]
    packed = event_disparity_scatter(batch, t_bin, eng.tables, **kw).packed_map
    runs = designs(lib, packed, eng.tables, eng.plan)
    result = {}
    for variant, opts in VARIANTS.items():
        ref = colorize_camera_plain(packed, eng.tables, eng.plan, **opts)
        for name, fn in runs.items():
            cs.assert_exact(f"{name} ({variant})", list(zip(fn(**opts), ref)))
        turns = {name: [] for name in runs}
        for name in [*runs, *reversed(runs)]:
            turns[name].append(cs.device_ms(lambda: runs[name](**opts))[0])
        result[variant] = {name: dict(ms=sum(t) / 2, turns=t) for name, t in turns.items()}
        print(f"{variant}, bit-equal to the plain version, ms a call (turns): " + "; ".join(
            f"{name} {r['ms']:.5f} ({r['turns'][0]:.5f}, {r['turns'][1]:.5f})"
            for name, r in result[variant].items()) + f" [{smi}]", flush=True)
    print(json.dumps(dict(card=smi, px=packed.numel(),
                          distinct_disparities=cs.distinct_disparities(packed),
                          variants=result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
