"""Build and load the package's CUDA kernels.

The sources in ``xmaps_tpu_torch/csrc/`` are compiled with ``nvcc`` (one
process a source, all started together) and linked into one shared library
with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/xmaps_tpu_torch/`` beside the package
(override with ``XMAPS_TORCH_BUILD_DIR``), named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at once.
There is no fallback: a missing ``nvcc`` or a failed build raises.

The package's host C++ libraries (the event decoder, the group staging) are
built the same way with ``g++`` (``host_library_path``,
``build_host_library``): one library a source, named by its hash.  So
decoding an EVT file and staging a ``process_frames`` group of the
decoder's record type need ``g++`` on any device; a missing ``g++`` raises.

Each kernel wrapper launches through ``launch``, which runs the C entry on
the device of the wrapper's tensors and counts the launch in ``LAUNCHES``
(by kernel name, a group entry over F frames apart from its one-frame
entries, one count a group), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from xmaps_tpu_torch.utils.stats import span

__all__ = ["load", "launch", "LAUNCHES", "reset_launch_counts", "check", "NVCC_FLAGS",
           "build_dir", "GXX_FLAGS", "host_library_path", "build_host_library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("events.cu", "tail.cu", "esl.cu", "remap.cu", "warmup.cu", "store_loop.cu",
           "filters.cu", "esl_refine.cu", "esl_denoise.cu")
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
    "event_disparity_scatter_group": 0,
    "tail_projector_group": 0,
    "colorize_camera_group": 0,
    "colorize_table": 0,
    "esl_disparity_search": 0,
    "remap_gather": 0,
    "warmup_add_one": 0,
    "tile_store_last": 0,
    "frame_dedup_filter": 0,
    "frame_dedup_filter_group": 0,
    "esl_refine": 0,
    "esl_denoise": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_long

#: C signatures (all return cudaGetLastError() as int)
_SIGNATURES = {
    "event_disparity_scatter": [
        _P, _P, _P, _P, _P, _I, _I,  # x, y, t_bin, valid, priority (nullable), n, index_offset
        _P, _I, _I,  # cam LUT (packed i32), cam_h, cam_w
        _P, _I, _I,  # x_map (i16), xmap_h, xmap_w
        _I, _I, _I, _I, _I,  # camera_view, oy, ox, out_h, out_w
        _P, _P,  # packed map, inlier count
        _P, _P, _P,  # optional lane outputs xr, yr, x_proj
        _P,  # stream
    ],
    "event_disparity_scatter_staged": [  # kernel 1 on the 1-word staged batch
        _P, _I, _I, _I, _I,  # words (i32), host count, bits_x, bits_y, bits_t
        _P, _I, _I,  # cam LUT (packed i32), cam_h, cam_w
        _P, _I, _I,  # x_map (i16), xmap_h, xmap_w
        _I, _I, _I, _I, _I,  # camera_view, oy, ox, out_h, out_w
        _P, _P,  # packed map, inlier count
        _P,  # stream
    ],
    "event_disparity_scatter_ring": [  # kernel 1 on the packet ring's rows
        _P, _P, _P, _P,  # host: k row pointers, k start lanes, k counts, k time offsets
        _I, _I, _I, _I,  # k, host count, bits_x, bits_y
        _I, _I, _I,  # t_min, t_max (the frame's, host), t_px_scale
        _P, _I, _I,  # cam LUT (packed i32), cam_h, cam_w
        _P, _I, _I,  # x_map (i16), xmap_h, xmap_w
        _I, _I, _I, _I, _I,  # camera_view, oy, ox, out_h, out_w
        _P, _P,  # packed map, inlier count
        _P,  # stream
    ],
    "event_disparity_scatter_group": [  # kernel 1 over F frames' (F, cap) rows
        _P, _P, _P, _P, _P,  # x, y, t_bin, valid, priority (nullable)
        _I, _I, _I,  # F, cap (lanes a frame), index_offset
        _P, _I, _I,  # cam LUT (packed i32), cam_h, cam_w
        _P, _I, _I,  # x_map (i16), xmap_h, xmap_w
        _I, _I, _I, _I, _I,  # camera_view, oy, ox, out_h, out_w
        _P, _P,  # (F, out_h, out_w) packed maps, (F,) inlier counts
        _P,  # stream
    ],
    "event_disparity_scatter_staged_group": [  # kernel 1 over F staged rows
        _P, _P, _I, _I,  # (F, cap) words (i32), (F,) device counts, F, cap
        _I, _I, _I,  # bits_x, bits_y, bits_t
        _P, _I, _I,  # cam LUT (packed i32), cam_h, cam_w
        _P, _I, _I,  # x_map (i16), xmap_h, xmap_w
        _I, _I, _I, _I, _I,  # camera_view, oy, ox, out_h, out_w
        _P, _P,  # (F, out_h, out_w) packed maps, (F,) inlier counts
        _P,  # stream
    ],
    "tail_projector_group": [  # kernel 2 over F crops: the dilate, then the remap
        _P, _I, _I, _I, _I, _I, _I, _I,  # crops, F, H, W, row0, col0, full_h, full_w
        _P,  # (F, H, W) u16 scratch
        _P, _P, _I, _I, _L,  # proj_mapx, proj_mapy, Hp, Wp, a frame's output stride (px)
        _P, _P,  # the (PACK,) BGR (i32) and depth (f32) tables
        _P, _P, _P, _P,  # bgr_packed, bgr3, depth, disp (nullable)
        _P,  # stream
    ],
    "colorize_camera": [  # 4 px a thread through the per-engine table
        _P, _I,  # packed map (16-byte aligned), n pixels
        _P, _P,  # the (PACK,) BGR (i32) and depth (f32) tables
        _P, _P, _P, _P,  # bgr_packed, bgr3, depth, disp (nullable)
        _P,  # stream
    ],
    "colorize_table": [
        _P, _F, _F, _F,  # lut, p03, z_near, z_far
        _P, _P,  # the (PACK,) BGR (i32) and depth (f32) tables out
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
        _P, _L,  # src f32, its element count (< 2**31)
        _P, _L,  # packed flat index (i32, -1 = zero, 16-byte aligned), n
        _P,  # out f32 (16-byte aligned)
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
    "frame_dedup_filter": [  # kernel F on one frame's (n,) lanes
        _P, _P, _P, _P, _P, _I,  # x, y, p (i32), valid (bool), t (i32 or f32), t is f32
        _I, _I, _I, _I,  # n, filter (index in FILTER_NAMES), key width, n_keys
        _P, _I, _I,  # packed cam LUT (first_per_yt, else null), lut_h, lut_w
        _P, _P,  # scratch: zeroed (i32, zero at entry and exit), work (i32)
        _P, _P, _P,  # keep (bool), t (mean filter, else null), priority (i32) out
        _P,  # stream
    ],
    "frame_dedup_filter_group": [  # kernel F over F frames' (F, n) rows
        _P, _P, _P, _P, _P, _I,  # x, y, p (i32), valid (bool), t (i32 or f32), t is f32
        _I, _I, _I, _I, _I,  # F, n, filter (index in FILTER_NAMES), key width, n_keys
        _P, _I, _I,  # packed cam LUT (first_per_yt, else null), lut_h, lut_w
        _P, _P,  # scratch: zeroed (i32, zero at entry and exit), work (i32)
        _P, _P, _P,  # keep (bool), t (mean filter, else null), priority (i32) out
        _P,  # stream
    ],
    "esl_refine": [  # kernel R over an (F, H, W) group of scans
        _P, _P, _P, _P, _P,  # depth0, filled camera image, rays x_n, y_n (H, W), constants
        _I, _I, _I, _I, _I, _I, _I, _I,  # F, H, W, w, window_size, Hp, Wp, iters
        _P,  # refined depth (F, H, W) out
        _P,  # stream
    ],
    "esl_bilateral": [  # kernel D's bilateral over an (F, H, W) group
        _P, _I, _I, _I, _I,  # depth, F, H, W, window half-width
        _F, _F,  # inv2sc, inv2ss
        _P,  # filtered (F, H, W) out
        _P,  # stream
    ],
    "esl_tv_iteration": [  # kernel D's outer TV iteration over an (F, H, W) group
        _P, _P, _P, _P,  # y, u, bx, by (the previous b; nullable: 0)
        _I, _I, _I,  # F, H, W
        _F, _F, _F, _F,  # mu, lam, thresh, diag
        _I, _I,  # niter_inner, first iteration
        _P, _P, _P,  # u, bx, by out (b nullable: not written)
        _P,  # stream
    ],
    "esl_denoise_exp": [  # kernel D's weight function on n floats
        _P, _L, _P,  # x, n, out
        _P,  # stream
    ],
    "esl_denoise_quotient": [  # kernel D's division by d of n floats
        _P, _L, _F, _P,  # x, n, d, out
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


#: g++ flags of the host libraries
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def host_library_path(src: Path, stem: str) -> Path:
    """Where the host library of the C++ source ``src`` is built, keyed by
    the source's content and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    return build_dir() / f"{stem}-{h.hexdigest()[:16]}.so"


def build_host_library(src: Path, path: Path) -> None:
    """Compile ``src`` with g++ to ``path`` under a temporary name and rename
    it into place, so a concurrent process never loads a half-written
    library; raises if ``g++`` is missing or fails."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run g++ to build {src.name}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)


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


def launch(dev: torch.device, kernel: str, entry: str, *args) -> None:
    """Call the library's C entry ``entry`` with ``args`` and the current
    stream of ``dev``, with ``dev`` the current CUDA device for the call;
    raise on the CUDA error it returns, else count one launch of
    ``kernel``.

    ``dev`` is the device of the wrapper's tensors.  The C side launches
    into the context of the *current* device and looks up its per-device
    state there (kernel 1's cooperative grid is sized by
    ``cudaGetDevice``'s occupancy), so without the guard a launch on
    ``cuda:1`` tensors while ``cuda:0`` is current would run in the wrong
    context on another card's pointers.  On a machine with one card every
    tensor lies on the current device, so no run there can show that
    fault: only a second card (or the guard) does.
    """
    with span("kernel.launch", kernel):
        fn = getattr(load(), entry)
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        check(entry, err)
        LAUNCHES[kernel] += 1
