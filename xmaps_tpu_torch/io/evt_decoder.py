"""Event RAW decoding: ctypes bindings to the native decoder, and NumPy
decoders as its plain versions.

Port of ``xmaps_tpu.io.evt_decoder``.  The native path is the repository's
host C++ decoder ``csrc/evt_decoder.cpp`` (shared with the JAX package; it
replaces Metavision's RawReaderBase, reference bias_events_iterator.py:
83-90).  This package builds its own copy with ``g++`` at first use into
``build/xmaps_tpu_torch/`` (``XMAPS_TORCH_BUILD_DIR`` overrides it), named by
a hash of the source and flags; it is written under a temporary name and
renamed into place, so a concurrent process never loads a half-written
library.  A failed build raises.  The NumPy decoders are the plain versions
the tests hold the native one against; they run only when the caller asks
for them (``force_numpy=True``), never in place of a failed build.

Supported containers:
- Prophesee RAW with EVT 2.0 payload (Gen3 cameras, the ESL dataset);
- Prophesee RAW with EVT 3.0 payload (Gen4+);
- Prophesee DAT (t, packed x/y/p records);
- .npy structured arrays (pre-decoded events, for tests/eval).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from xmaps_tpu_torch.ops._build import build_host_library, host_library_path
from xmaps_tpu_torch.utils.stats import span

__all__ = [
    "EVENT_DTYPE",
    "EvtDecoder",
    "decode_dat_numpy",
    "decode_evt2_numpy",
    "decode_evt3_numpy",
    "decode_file",
    "load_native",
    "parse_raw_header",
]

EVENT_DTYPE = np.dtype(
    [("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<i8")]
)

#: the repository's host C++ decoder and stream filters
CSRC = Path(__file__).resolve().parent.parent.parent / "csrc" / "evt_decoder.cpp"

_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    """Build-artifact path, keyed by the source content and the flags."""
    return host_library_path(CSRC, "libevt_decoder")


def _build(path: Path) -> None:
    """Compile ``csrc/evt_decoder.cpp`` to ``path`` (atomically; raises if
    ``g++`` is missing or fails)."""
    build_host_library(CSRC, path)


def load_native() -> ctypes.CDLL:
    """Build (once per source hash) and load the native decoder library."""
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    lib.evt_open.restype = ctypes.c_void_p
    lib.evt_open.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.evt_close.argtypes = [ctypes.c_void_p]
    lib.evt_get_width.restype = ctypes.c_int32
    lib.evt_get_width.argtypes = [ctypes.c_void_p]
    lib.evt_get_height.restype = ctypes.c_int32
    lib.evt_get_height.argtypes = [ctypes.c_void_p]
    lib.evt_get_format.restype = ctypes.c_int32
    lib.evt_get_format.argtypes = [ctypes.c_void_p]
    lib.evt_decode.restype = ctypes.c_int64
    lib.evt_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.act_filter_create.restype = ctypes.c_void_p
    lib.act_filter_create.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int64]
    lib.act_filter_apply.restype = ctypes.c_int64
    lib.act_filter_apply.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, u16p, u16p,
        np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]
    lib.act_filter_destroy.argtypes = [ctypes.c_void_p]
    lib.act_filter_reset.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# NumPy decoders (the native decoder's plain versions)
# ---------------------------------------------------------------------------


def parse_raw_header(data: bytes) -> tuple[int, str, Optional[tuple[int, int]]]:
    """Parse '%'-prefixed ASCII header; returns (header_len, format, geometry)."""
    pos = 0
    fmt = ""
    geom = None
    while pos < len(data):
        end = data.find(b"\n", pos)
        if end < 0:
            end = len(data)
        line = data[pos : end + 1]
        if not line.startswith(b"%"):
            break
        text = line.decode("latin-1")
        if "format EVT2" in text or "evt 2.0" in text:
            fmt = "EVT2"
        elif "format EVT3" in text or "evt 3.0" in text:
            fmt = "EVT3"
        if "geometry " in text:
            try:
                g = text.split("geometry ")[1].strip().split(";")[0]
                w, h = g.split("x")
                geom = (int(w), int(h))
            except (ValueError, IndexError):
                pass
        pos = end + 1
        if text.strip() == "% end":
            break
    return pos, fmt, geom


def decode_evt2_numpy(words: np.ndarray) -> np.ndarray:
    """Vectorized EVT2 decode of uint32 words -> structured events."""
    types = words >> 28
    is_cd = types <= 1
    is_th = types == 0x8

    th_vals = (words & 0x0FFFFFFF).astype(np.int64)
    # forward-fill the last TIME_HIGH at each position
    th_idx = np.where(is_th)[0]
    if len(th_idx) == 0:
        return np.zeros(0, dtype=EVENT_DTYPE)
    # rollover detection on consecutive TIME_HIGH values
    th_seq = th_vals[th_idx]
    drops = np.diff(th_seq) < -(1 << 27)
    ovf = np.concatenate([[0], np.cumsum(drops)]).astype(np.int64)
    th_full = (ovf << 28) | th_seq

    # position of the latest TIME_HIGH before each word
    fill = np.searchsorted(th_idx, np.arange(len(words)), side="right") - 1
    valid_cd = is_cd & (fill >= 0)
    cd_words = words[valid_cd]
    cd_th = th_full[fill[valid_cd]]

    out = np.zeros(int(valid_cd.sum()), dtype=EVENT_DTYPE)
    out["t"] = (cd_th << 6) | ((cd_words >> 22) & 0x3F).astype(np.int64)
    out["x"] = ((cd_words >> 11) & 0x7FF).astype(np.uint16)
    out["y"] = (cd_words & 0x7FF).astype(np.uint16)
    out["p"] = (cd_words >> 28).astype(np.int16)
    return out


def decode_evt3_numpy(words: np.ndarray) -> np.ndarray:
    """EVT3 decode of uint16 words (scalar loop; the native decoder's
    plain version)."""
    out_x, out_y, out_p, out_t = [], [], [], []
    cur_y = 0
    time_high = -1
    time_low = 0
    ovf = 0
    base_x = 0
    pol = 0
    for w in words.tolist():  # python ints: avoid uint16 overflow in shifts
        typ = w >> 12
        if typ == 0x0:
            cur_y = w & 0x7FF
        elif typ == 0x2:
            if time_high >= 0:
                t = (((ovf << 12) + time_high) << 12) | time_low
                out_x.append(w & 0x7FF)
                out_y.append(cur_y)
                out_p.append((w >> 11) & 1)
                out_t.append(t)
        elif typ == 0x3:
            pol = (w >> 11) & 1
            base_x = w & 0x7FF
        elif typ in (0x4, 0x5):
            bits = 12 if typ == 0x4 else 8
            if time_high >= 0:
                t = (((ovf << 12) + time_high) << 12) | time_low
                mask = w & ((1 << bits) - 1)
                for i in range(bits):
                    if mask & (1 << i):
                        out_x.append(base_x + i)
                        out_y.append(cur_y)
                        out_p.append(pol)
                        out_t.append(t)
            base_x += bits
        elif typ == 0x6:
            time_low = w & 0xFFF
        elif typ == 0x8:
            th = w & 0xFFF
            if time_high >= 0 and th < time_high and (time_high - th) > (1 << 11):
                ovf += 1
            time_high = th
            # TIME_HIGH combines with the last received TIME_LOW (spec);
            # low bits persist until the next TIME_LOW word
    out = np.zeros(len(out_x), dtype=EVENT_DTYPE)
    out["x"] = out_x
    out["y"] = out_y
    out["p"] = out_p
    out["t"] = out_t
    return out


def decode_dat_numpy(payload: np.ndarray) -> np.ndarray:
    """DAT record decode: (u32 t, u32 data) pairs."""
    recs = payload.reshape(-1, 2)
    out = np.zeros(len(recs), dtype=EVENT_DTYPE)
    out["t"] = recs[:, 0].astype(np.int64)
    out["x"] = (recs[:, 1] & 0x3FFF).astype(np.uint16)
    out["y"] = ((recs[:, 1] >> 14) & 0x3FFF).astype(np.uint16)
    out["p"] = ((recs[:, 1] >> 28) & 0xF).astype(np.int16)
    return out


def _decode_numpy(path: str) -> tuple[np.ndarray, Optional[tuple[int, int]]]:
    """Slurp and decode a RAW/DAT file with the NumPy decoders."""
    with open(path, "rb") as f:
        data = f.read()
    hdr_len, fmt, geom = parse_raw_header(data)
    payload = data[hdr_len:]
    if path.endswith(".dat"):
        payload = payload[2:]  # event type + size bytes
        return decode_dat_numpy(
            np.frombuffer(payload[: len(payload) // 8 * 8], dtype="<u4")
        ), geom
    if fmt == "EVT3":
        return decode_evt3_numpy(
            np.frombuffer(payload[: len(payload) // 2 * 2], dtype="<u2")
        ), geom
    # EVT2 default (Gen3)
    return decode_evt2_numpy(
        np.frombuffer(payload[: len(payload) // 4 * 4], dtype="<u4")
    ), geom


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


class EvtDecoder:
    """Streaming decoder for a RAW/DAT/NPY event file.

    Decodes RAW/DAT with the native C++ decoder, or with the NumPy
    decoders when ``force_numpy`` is set.  Yields structured arrays
    (EVENT_DTYPE) in chunks of up to ``chunk_events``.
    """

    def __init__(self, path: str, chunk_events: int = 1 << 20,
                 force_numpy: bool = False):
        self.path = path
        self.chunk_events = chunk_events
        self.width: Optional[int] = None
        self.height: Optional[int] = None
        self._native = None
        self._npy: Optional[np.ndarray] = None

        if path.endswith(".npy"):
            arr = np.load(path)
            if arr.dtype.names is None or not set("xytp") <= set(arr.dtype.names):
                raise ValueError(f"{path}: .npy must be a structured x/y/p/t array")
            self._npy = arr
            return
        if force_numpy:
            self._npy, geom = _decode_numpy(path)
            if geom:
                self.width, self.height = geom
            return
        lib = load_native()
        handle = lib.evt_open(path.encode(), 0)
        if not handle:
            raise OSError(f"native event decoder cannot open {path!r}")
        self._native = (lib, ctypes.c_void_p(handle))
        self.width = lib.evt_get_width(self._native[1]) or None
        self.height = lib.evt_get_height(self._native[1]) or None

    def close(self):
        if self._native is not None:
            lib, h = self._native
            lib.evt_close(h)
            self._native = None

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._native is not None:
            lib, h = self._native
            while True:
                # closed before the yield: the consumer's time is not the decode's
                with span("io.decode"):
                    xs = np.empty(self.chunk_events, dtype=np.uint16)
                    ys = np.empty(self.chunk_events, dtype=np.uint16)
                    ps = np.empty(self.chunk_events, dtype=np.int16)
                    ts = np.empty(self.chunk_events, dtype=np.int64)
                    n = lib.evt_decode(h, self.chunk_events, xs, ys, ps, ts)
                    if n <= 0:
                        break
                    out = np.zeros(n, dtype=EVENT_DTYPE)
                    out["x"] = xs[:n]
                    out["y"] = ys[:n]
                    out["p"] = ps[:n]
                    out["t"] = ts[:n]
                yield out
        else:
            arr = self._npy
            for i in range(0, len(arr), self.chunk_events):
                yield arr[i : i + self.chunk_events].astype(
                    EVENT_DTYPE, copy=False
                )


def decode_file(path: str, force_numpy: bool = False) -> np.ndarray:
    """Decode an entire event file into one structured array."""
    dec = EvtDecoder(path, force_numpy=force_numpy)
    chunks = list(dec)
    dec.close()
    if not chunks:
        return np.zeros(0, dtype=EVENT_DTYPE)
    return np.concatenate(chunks)
