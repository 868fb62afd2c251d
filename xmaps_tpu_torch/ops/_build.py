"""Build and load the package's CUDA kernels.

The sources in ``xmaps_tpu_torch/csrc/`` are compiled with ``nvcc`` (one
process a source, all started together) and linked into one shared library
with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/xmaps_tpu_torch/`` beside the package
(override with ``XMAPS_TORCH_BUILD_DIR``), named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at once.
There is no fallback: a missing ``nvcc`` or a failed build raises.

Each kernel wrapper counts its launches in ``LAUNCHES`` (by kernel name),
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load", "LAUNCHES", "reset_launch_counts", "check", "NVCC_FLAGS", "build_dir"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("events.cu", "tail.cu", "esl.cu", "remap.cu", "warmup.cu", "store_loop.cu")
HEADERS = ("common.cuh",)

#: sm_90a for Hopper; no --use_fast_math: the f32 epilogue (p03/disp, the
#: u8 normalization) must round exactly as IEEE, as JAX does.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC",
)

#: kernel name -> launches since the last reset
LAUNCHES = {
    "event_disparity_scatter": 0,
    "tail_projector": 0,
    "colorize_camera": 0,
    "esl_disparity_search": 0,
    "remap_gather": 0,
    "warmup_add_one": 0,
    "tile_store_last": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_long

#: C signatures (all return cudaGetLastError() as int)
_SIGNATURES = {
    "event_disparity_scatter": [
        _P, _P, _P, _P, _P, _I,  # x, y, t_bin, valid, priority (nullable), n
        _P, _I, _I,  # cam LUT (packed i32), cam_h, cam_w
        _P, _I, _I,  # x_map (i16), xmap_h, xmap_w
        _I, _I, _I, _I, _I,  # camera_view, oy, ox, out_h, out_w
        _P, _P,  # packed map, inlier count
        _P, _P, _P,  # optional lane outputs xr, yr, x_proj
        _P,  # stream
    ],
    "tail_projector": [
        _P, _I, _I, _I, _I, _I, _I,  # packed crop, H, W, row0, col0, full_h, full_w
        _P, _P, _I, _I,  # proj_mapx, proj_mapy, Hp, Wp
        _P, _F, _F, _F,  # lut, p03, z_near, z_far
        _P, _P, _P, _P,  # bgr_packed, bgr3, depth, disp (nullable)
        _P,  # stream
    ],
    "colorize_camera": [
        _P, _I,  # packed map, n pixels
        _P, _F, _F, _F,  # lut, p03, z_near, z_far
        _P, _P, _P, _P,  # bgr_packed, bgr3, depth, disp (nullable)
        _P,  # stream
    ],
    "esl_disparity_search": [
        _P, _I, _I,  # cam (Hc, Wc) f32, Hc, Wc
        _P, _P, _P, _P, _P, _I,  # G, F, N, R, C tables (Hc, W_pad), W_pad
        _I, _I, _I, _I,  # W (window clip), min_disp, max_disp, steps
        _P,  # out (Hc, Wc) f32
        _P,  # stream
    ],
    "remap_gather": [
        _P, _I, _I,  # src f32, Hs, Ws
        _P, _P, _P, _L,  # yi, xi (i32), inb (bool, nullable), n
        _P,  # out f32
        _P,  # stream
    ],
    "warmup_add_one": [
        _P, _P, _L,  # x, out (i32), n
        _P,  # stream
    ],
    "tile_store_last": [
        _P, _P, _P, _I,  # rows, cols (i32), vals (u32 as i32), n
        _I, _I, _P,  # H, W, out (H, W) u32 as i32
        _P,  # stream
    ],
}

_LIB = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    """Where the package's native libraries are built and cached."""
    env = os.environ.get("XMAPS_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "xmaps_tpu_torch"


#: where nvcc is looked for after PATH and $CUDA_HOME/bin
DEFAULT_CUDA_HOME = "/usr/local/cuda"


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
            cand = Path(root or "") / "bin" / "nvcc"
            if root and cand.is_file():
                nvcc = str(cand)
                break
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "xmaps_tpu_torch CUDA kernels are built from csrc/ at first use "
            "and have no fallback"
        )
    return nvcc


def load(verbose: bool = False) -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    nvcc = _find_nvcc()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libxmaps_kernels_{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        # compile every source at once into a private directory, link under
        # a temporary name and rename: concurrent builders never load a
        # half-written library
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
            ptxas = ["-Xptxas", "-v"] if verbose else []
            objs = [os.path.join(tmp_dir, f"{src}.o") for src in SOURCES]
            compiles = [[nvcc, *ptxas, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)]
                        for src, obj in zip(SOURCES, objs)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in compiles]
            results = [(cmd, p.communicate()[0], p.returncode)
                       for cmd, p in zip(compiles, procs)]
            tmp = os.path.join(tmp_dir, "lib.so")
            if all(rc == 0 for _, _, rc in results):
                link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
                proc = subprocess.run(link, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                results.append((link, proc.stdout, proc.returncode))
            for cmd, out, rc in results:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
                if verbose:
                    print(out)
            os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")
