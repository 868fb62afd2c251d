"""The native group staging: ctypes bindings to ``csrc/stage_pack.cpp``.

``io.prefetch`` stages a group's frames at one word an event through these
two entries where a frame is a run of the decoder's records
(``EVENT_DTYPE``: ``x``, ``y`` and ``t`` ``<u2``, ``<u2`` and ``<i8`` at
bytes 0, 2 and 6 of a 14-byte record, every record in turn): ``scan``
(does every pixel fit the layout, and the time range of the events that
are staged) and ``pack`` (the words, straight into the rows of the pinned
buffer).  Each is one call a group.  ``io.prefetch``'s NumPy check and pack
are their plain versions, and stage every other frame, strided or
reordered record views among them.

The library is built with ``g++`` at first use into the package's build
directory (``ops._build.build_host_library``); a CUDA engine loads it when
it is built, so no build lands in a timed call, a CPU engine at its first
native staging.  A missing ``g++`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import numpy as np

from xmaps_tpu_torch.ops._build import build_host_library, host_library_path

__all__ = ["load", "native_fields", "addresses", "scan", "pack", "MAX_SPAN"]

SRC = Path(__file__).resolve().parent.parent / "csrc" / "stage_pack.cpp"

#: the native pack bins a frame only where its time range times the scale is
#: below this (the quotient then comes exactly from doubles)
MAX_SPAN = 1 << 52

#: the decoder's record as the native entries read it: each field's type
#: and byte offset, and the record stride
_FIELDS = {"x": (np.dtype("<u2"), 0), "y": (np.dtype("<u2"), 2), "t": (np.dtype("<i8"), 6)}
_STRIDE = 14

_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the library."""
    global _lib
    if _lib is None:
        path = host_library_path(SRC, "libstage_pack")
        if not path.exists():
            build_host_library(SRC, path)
        lib = ctypes.CDLL(str(path))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.xm_stage_scan.restype = i32
        lib.xm_stage_scan.argtypes = [i32, p, p, i64, i32, i32, p, p]
        lib.xm_stage_pack.restype = None
        lib.xm_stage_pack.argtypes = [i32, p, p, p, i64, i32, i32, i64, p, p, p]
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _decoder_record(dtype: np.dtype) -> bool:
    """Whether a record type has the decoder's x, y and t: their types at
    their offsets."""
    f = dtype.fields
    return f is not None and all(k in f and f[k][:2] == d for k, d in _FIELDS.items())


def native_fields(evs: np.ndarray) -> bool:
    """Whether the native entries read ``evs``: a 1-D array of the decoder's
    records, one after another (a record stride of 14 bytes)."""
    return (evs.ndim == 1 and (len(evs) < 2 or evs.strides[0] == _STRIDE)
            and _decoder_record(evs.dtype))


def addresses(frames: list) -> np.ndarray:
    """(2, F) int64: the address of each frame's first record and its
    length, for ``scan`` and ``pack`` (valid while the frames are)."""
    return np.array([[evs.ctypes.data for evs in frames], [len(evs) for evs in frames]],
                    np.int64).reshape(2, len(frames))


def scan(addr: np.ndarray, capacity: int, bits_x: int, bits_y: int) -> tuple:
    """(fits, (F,) t_lo, (F,) t_hi) of the frames whose ``addresses`` are
    ``addr``: whether every event's x and y fit ``bits_x`` and ``bits_y``,
    and each frame's min and max t over its first ``min(len, capacity)``
    events (0 and 0 where it has none)."""
    addr = np.ascontiguousarray(addr)
    lo, hi = np.empty((2, addr.shape[1]), np.int64)
    fits = load().xm_stage_scan(addr.shape[1], *(r.ctypes.data for r in addr), capacity,
                                bits_x, bits_y, lo.ctypes.data, hi.ctypes.data)
    return bool(fits), lo, hi


def pack(addr: np.ndarray, rows: list, counts, capacity: int, bits_x: int, bits_y: int,
         t_px_scale: int, t_lo, t_hi) -> None:
    """Write the first ``counts[i]`` events of the frame whose ``addresses``
    are ``addr[:, i]`` into the uint32 row ``rows[i]`` (``capacity``
    words, C-contiguous) at one word an event, as ``io.prefetch``'s NumPy
    pack does, and zero the rest of the row.  ``t_lo``, ``t_hi``: the
    frames' ``scan``; each frame's ``max(t_hi - t_lo, 1) * t_px_scale``
    must be below ``MAX_SPAN``."""
    addr = np.ascontiguousarray(addr)
    aux = np.array([counts, [r.ctypes.data for r in rows], t_lo, t_hi], np.int64)
    table = np.empty(capacity + 1, np.uint32)  # the C side's scratch
    load().xm_stage_pack(addr.shape[1], addr[0].ctypes.data,
                         *(r.ctypes.data for r in aux[:2]), capacity, bits_x, bits_y,
                         t_px_scale, *(r.ctypes.data for r in aux[2:]), table.ctypes.data)
