"""Frame event dedup filters (fixed-shape torch ops).

Port of ``xmaps_tpu.ops.filters``.  The reference offers 5 per-frame dedup
strategies selectable at runtime with the E key
(frame_event_filter.py:131-151).  They rebuild a smaller event list by
scattering into dense pixel maps and re-extracting in raster order.  Here,
as in the JAX package, each filter is a transformation of the padded batch:

- a validity mask update (drop filtered-out lanes), and
- optionally a rewritten timestamp (MeanFirstLastEventPerXY), and
- a scatter priority (events re-emerge in raster order in the reference, so
  the disparity-map scatter must use the pixel raster index as last-write
  priority to stay bit-exact; see ``scatter_priority``).

All filters first drop negative-polarity events
(frame_event_filter.py:21,47,72,104).  NoFilter is the default.

Deviation note (as in the JAX package): the reference implements "first
event wins" via a reversed-array fancy-index scatter
(frame_event_filter.py:52-53), whose duplicate-index winner is undefined
behavior in NumPy.  These filters implement the documented intent (true
first event by stream order) deterministically.

A key outside its key space (an event outside the camera: a larger
sensor, or a camera width below the sensor's) is treated as JAX's index
modes treat it (``_jax_index``): a negative key counts from the end of the
map, the scatters (``mode="drop"``) drop a key still outside it, and the
gathers clamp it.

``apply_frame_filter`` runs the plain version (``apply_frame_filter_plain``:
a stable sort, ``scatter_reduce_`` and gathers) on CPU tensors, and on CUDA
tensors launches kernel F ``frame_dedup_filter`` (``csrc/filters.cu``), one
launch a frame, which also rectifies first_per_yt's x through the camera
LUT itself.  ``apply_frame_filter_group`` filters F frames of a stacked
batch, in one launch of ``frame_dedup_filter_group`` on CUDA.  The
kernel's keep mask and time equal the plain version's bit for bit; its
priority is each survivor's rank among its frame's survivors by raw key
(0 for a dropped lane), which orders the survivors as the plain dense
rank does.  Kernel 1 (``ops.cuda_events``) takes either.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from xmaps_tpu_torch.ops import _build
from xmaps_tpu_torch.ops.event_batch import EventBatch
from xmaps_tpu_torch.ops.scatter import MAX_CAPACITY

__all__ = [
    "FILTER_NAMES",
    "FilteredBatch",
    "apply_frame_filter",
    "apply_frame_filter_group",
    "apply_frame_filter_group_plain",
    "apply_frame_filter_plain",
    "check_filter_lanes",
    "check_filter_name",
    "lut_rectified_x",
]

#: the frame dedup filters, in the E key's cycle order
FILTER_NAMES = (
    "none",
    "first_per_yt",
    "first_per_xy",
    "last_per_xy",
    "mean_first_last_per_xy",
)


#: frames a group launch of kernel F takes (its tile totals a launch,
#: csrc/filters.cu MAX_TILES)
MAX_GROUP_FRAMES = 2048


class FilteredBatch(NamedTuple):
    batch: EventBatch
    #: (N,) int32 per-lane scatter priority; for the dedup filters the
    #: dense raster RANK (plain version, see _dense_rank) or the survivors'
    #: rank by raw key (kernel F), the event order for NoFilter
    scatter_priority: torch.Tensor


def check_filter_name(name: str) -> None:
    """Raise ValueError for a name not in FILTER_NAMES."""
    if name not in FILTER_NAMES:
        raise ValueError(f"unknown frame filter {name!r}")


def _dense_rank(key: torch.Tensor) -> torch.Tensor:
    """Rank of each lane under (key, lane) lexicographic order, over all
    lanes (padding lanes included, as the JAX package ranks them).

    The dedup filters' scatter priority is the reference's raster
    position.  Raw raster keys overflow the uint32 packing at ESL scale
    (camera_height * rect_width ~ 2.8M), but only their ORDER matters and
    every filter keeps at most one survivor per key, so the dense rank
    (< capacity) is an equivalent priority."""
    n = key.shape[0]
    order = torch.sort(key, stable=True).indices
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    return torch.empty_like(idx).scatter_(0, order, idx)


def _jax_index(k: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(scatter index, gather index) of integer keys into a map of ``size``
    slots, as JAX indexes ``.at[k].max(..., mode="drop")`` and ``map[k]``:
    a negative key first counts from the end (k + size); the scatter then
    drops a key still outside [0, size), which goes here to a spare slot
    ``size`` past the map that no gather reads, and the gather clamps it
    into [0, size - 1].  A plain clamp would alias a real pixel."""
    kn = k.long()
    kn = torch.where(kn < 0, kn + size, kn)
    inside = (kn >= 0) & (kn < size)
    return torch.where(inside, kn, size), kn.clamp(0, size - 1)


def _winner_mask(
    key: torch.Tensor, valid: torch.Tensor, n_keys: int, *, first: bool
) -> torch.Tensor:
    """Per-lane mask: is this lane the first/last valid event of its key?

    Scatter-max of (event index + 1) per key into ``n_keys + 1`` slots (the
    last one for invalid lanes), then compare with a gather.  For
    ``first``, indices are flipped so the smallest index wins."""
    n = key.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    prio = (n - idx) if first else (idx + 1)
    prio = torch.where(valid, prio, 0)
    put, get = _jax_index(torch.where(valid, key, n_keys), n_keys + 1)
    winners = torch.zeros(n_keys + 2, dtype=torch.int32, device=key.device)
    winners.scatter_reduce_(0, put, prio, reduce="amax")
    return valid & (winners[get] == prio)


def lut_rectified_x(x: torch.Tensor, y: torch.Tensor, cam_lut: torch.Tensor) -> torch.Tensor:
    """Per-lane rectified x (int32) read from the packed camera LUT
    (``DeviceTables.cam_map_packed``, mapy << 16 | mapx) at the clamped
    pixel: ``ops.disparity.rectify_events``' x, as kernel F reads it."""
    H, W = cam_lut.shape
    v = cam_lut[y.clamp(0, H - 1).long(), x.clamp(0, W - 1).long()]
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def apply_frame_filter(
    batch: EventBatch,
    x_rect_i16: Optional[torch.Tensor],
    *,
    name: str,
    camera_width: int,
    camera_height: int,
    rect_width: int,
    cam_lut: Optional[torch.Tensor] = None,
) -> FilteredBatch:
    """Apply one of the 5 reference dedup strategies to a padded batch.

    Args:
        batch: the frame's padded events.
        x_rect_i16: per-lane rectified x (int32), the ``xp_i16`` the
            reference passes to filters (depth_reprojection_pipe.py:131);
            read only by first_per_yt on CPU tensors, and may be None for
            the others, or where ``cam_lut`` is given.
        name: one of FILTER_NAMES.
        cam_lut: the packed camera LUT (``DeviceTables.cam_map_packed``):
            first_per_yt's x is then read from it (``lut_rectified_x``).
            On CUDA tensors first_per_yt requires it: kernel F rectifies x
            itself and reads no ``x_rect_i16``.

    CPU tensors run ``apply_frame_filter_plain``; CUDA tensors launch
    kernel F (``frame_dedup_filter``) for a dedup filter, or raise.
    """
    return _apply(batch, x_rect_i16, cam_lut, apply_frame_filter_plain, group=False, name=name,
                  camera_width=camera_width, camera_height=camera_height, rect_width=rect_width)


def apply_frame_filter_group(
    batch: EventBatch,
    x_rect_i16: Optional[torch.Tensor],
    *,
    name: str,
    camera_width: int,
    camera_height: int,
    rect_width: int,
    cam_lut: Optional[torch.Tensor] = None,
) -> FilteredBatch:
    """``apply_frame_filter`` of each frame of a stacked batch (each field
    ``(F, capacity)``, ``count`` ``(F,)``; ``x_rect_i16`` ``(F, capacity)``
    or None): the F frames' batches and priorities, stacked.  CPU tensors
    run ``apply_frame_filter_group_plain``; CUDA tensors launch kernel F's
    group entry (``frame_dedup_filter_group``) once for the F frames, or
    raise.  Frame f equals ``apply_frame_filter`` of frame f."""
    if batch.x.dim() != 2:
        raise ValueError(f"apply_frame_filter_group: lanes of shape {tuple(batch.x.shape)}, "
                         "not (F, capacity)")
    return _apply(batch, x_rect_i16, cam_lut, apply_frame_filter_group_plain, group=True,
                  name=name, camera_width=camera_width, camera_height=camera_height,
                  rect_width=rect_width)


def _apply(batch, x_rect_i16, cam_lut, plain, *, group, **kw) -> FilteredBatch:
    """``plain`` on CPU tensors (first_per_yt's x read from ``cam_lut``
    where no ``x_rect_i16`` is given) and for "none"; else kernel F."""
    check_filter_name(kw["name"])
    if batch.x.device.type == "cpu":
        if kw["name"] == "first_per_yt" and x_rect_i16 is None and cam_lut is not None:
            x_rect_i16 = lut_rectified_x(batch.x, batch.y, cam_lut)
        return plain(batch, x_rect_i16, **kw)
    if kw["name"] == "none":
        return plain(batch, None, **kw)
    return _frame_dedup_filter(batch, cam_lut, group=group, **kw)


def apply_frame_filter_group_plain(
    batch: EventBatch, x_rect_i16: Optional[torch.Tensor], **kw
) -> FilteredBatch:
    """Plain version of ``apply_frame_filter_group`` (any device): the
    one-frame plain version frame by frame, stacked."""
    out = [apply_frame_filter_plain(batch.frame(f), None if x_rect_i16 is None else x_rect_i16[f],
                                    **kw)
           for f in range(batch.x.shape[0])]
    return FilteredBatch(EventBatch(*(torch.stack(a) for a in zip(*(b for b, _ in out)))),
                         torch.stack([p for _, p in out]))


def check_filter_lanes(batch: EventBatch, name: str, cam_lut: Optional[torch.Tensor]) -> None:
    """Raise ValueError on a batch (or a stacked group) that kernel F does
    not take: lanes other than contiguous int32 x, y, p, bool valid and
    int32 or float32 t of one shape, (capacity,) or (F, capacity) with
    F <= ``MAX_GROUP_FRAMES``; a capacity above ``MAX_CAPACITY`` (kernel
    1's priority limit); for first_per_yt, no contiguous int32 (H, W)
    ``cam_lut``.  Any device: the kernel's wrapper also checks that every
    tensor lies on the batch's CUDA device."""
    shape = tuple(batch.x.shape)
    if len(shape) not in (1, 2) or shape[-1] < 1:
        raise ValueError(f"kernel F: lanes of shape {shape}, not (capacity,) or (F, capacity)")
    if shape[-1] > MAX_CAPACITY:
        raise ValueError(f"kernel F: capacity {shape[-1]} > {MAX_CAPACITY}")
    if len(shape) == 2 and not 1 <= shape[0] <= MAX_GROUP_FRAMES:
        raise ValueError(f"kernel F: {shape[0]} frames, not 1..{MAX_GROUP_FRAMES}")
    for field, dtypes in (("x", (torch.int32,)), ("y", (torch.int32,)), ("p", (torch.int32,)),
                          ("valid", (torch.bool,)), ("t", (torch.int32, torch.float32))):
        a = getattr(batch, field)
        if a.dtype not in dtypes or tuple(a.shape) != shape or not a.is_contiguous():
            kinds = " or ".join(map(str, dtypes))
            raise ValueError(f"kernel F: {field} must be a contiguous {kinds} tensor of shape "
                             f"{shape}, got {a.dtype} {tuple(a.shape)}"
                             f"{'' if a.is_contiguous() else ' (not contiguous)'}")
    if name == "first_per_yt":
        if cam_lut is None:
            raise ValueError("kernel F: first_per_yt rectifies x through the camera LUT; "
                             "pass cam_lut (DeviceTables.cam_map_packed)")
        if cam_lut.dtype != torch.int32 or cam_lut.dim() != 2 or not cam_lut.is_contiguous():
            raise ValueError(f"kernel F: cam_lut must be a contiguous int32 (H, W) tensor, got "
                             f"{cam_lut.dtype} {tuple(cam_lut.shape)}")


#: kernel F's scratch on each (device, stream): (the maps and bitmaps, zero
#: between launches, int32; the work area, int32), grown on demand
_SCRATCH: dict = {}


def _scratch(dev: torch.device, zeroed: int, work: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel F's scratch for a launch on ``dev``'s current stream: at
    least ``zeroed`` int32 that are zero (every launch leaves them zero
    again, so one allocation serves every later launch on the stream) and
    ``work`` int32 of any content."""
    key = (dev, torch.cuda.current_stream(dev))
    z, w = _SCRATCH.get(key, (None, None))
    if z is None or z.numel() < zeroed:
        z = torch.zeros(zeroed, dtype=torch.int32, device=dev)
    if w is None or w.numel() < work:
        w = torch.empty(work, dtype=torch.int32, device=dev)
    _SCRATCH[key] = (z, w)
    return z, w


def _frame_dedup_filter(batch, cam_lut, *, group, name, camera_width, camera_height,
                        rect_width):
    """Kernel F on a frame or a stacked group of CUDA lanes (see
    ``csrc/filters.cu``)."""
    check_filter_lanes(batch, name, cam_lut)
    dev = batch.x.device
    if dev.type != "cuda":
        raise ValueError(f"kernel F: unsupported device {dev}")
    tensors = list(batch[:5]) + ([cam_lut] if name == "first_per_yt" else [])
    if any(a.device != dev for a in tensors):
        raise ValueError(f"kernel F: every tensor must lie on {dev}")
    shape = tuple(batch.x.shape)
    frames, n = (shape[0] if group else 1), shape[-1]
    yt, mean = name == "first_per_yt", name == "mean_first_last_per_xy"
    key_w = rect_width if yt else camera_width
    n_keys = camera_height * key_w
    if not 0 < n_keys <= 1 << 29:
        raise ValueError(f"kernel F: {n_keys} keys, not 1..{1 << 29}")
    words = (2 * (n_keys + 1) + 31) // 32
    zeroed, work = _scratch(dev, frames * ((n_keys + 1) * (2 if mean else 1) + words),
                            2 * frames * words + MAX_GROUP_FRAMES)
    keep = torch.empty(shape, dtype=torch.bool, device=dev)
    prio = torch.empty(shape, dtype=torch.int32, device=dev)
    t_out = torch.empty_like(batch.t) if mean else None
    lut = (cam_lut.data_ptr(), *cam_lut.shape) if yt else (None, 0, 0)
    lanes = (batch.x.data_ptr(), batch.y.data_ptr(), batch.p.data_ptr(), batch.valid.data_ptr(),
             batch.t.data_ptr(), int(batch.t.dtype == torch.float32))
    tail = (FILTER_NAMES.index(name), key_w, n_keys, *lut, zeroed.data_ptr(), work.data_ptr(),
            keep.data_ptr(), None if t_out is None else t_out.data_ptr(), prio.data_ptr())
    entry = "frame_dedup_filter_group" if group else "frame_dedup_filter"
    _build.launch(dev, entry, entry, *lanes, *((frames,) if group else ()), n, *tail)
    out = batch._replace(valid=keep, t=t_out if mean else batch.t)
    return FilteredBatch(out, prio)


def apply_frame_filter_plain(
    batch: EventBatch,
    x_rect_i16: Optional[torch.Tensor],
    *,
    name: str,
    camera_width: int,
    camera_height: int,
    rect_width: int,
) -> FilteredBatch:
    """Plain PyTorch version of ``apply_frame_filter`` (any device; the
    JAX package's ``apply_frame_filter`` bit for bit), its priority the
    dense rank (``_dense_rank``)."""
    check_filter_name(name)
    n = batch.x.shape[0]
    idx_order = torch.arange(n, dtype=torch.int32, device=batch.x.device)

    if name == "none":
        return FilteredBatch(batch=batch, scatter_priority=idx_order)

    pos = batch.valid & (batch.p == 1)
    key_xy = batch.y * camera_width + batch.x
    n_xy = camera_width * camera_height

    if name in ("first_per_xy", "last_per_xy"):
        # reference frame_event_filter.py:45-64 (reversed scatter) / :19-39
        keep = _winner_mask(key_xy, pos, n_xy, first=name == "first_per_xy")
        return FilteredBatch(batch._replace(valid=keep), _dense_rank(key_xy))

    if name == "first_per_yt":
        # reference frame_event_filter.py:70-99: key = (raw y, rectified x)
        if x_rect_i16 is None:
            raise ValueError("first_per_yt keys on the rectified x: x_rect_i16 is None")
        xr = x_rect_i16.int().clamp(0, rect_width - 1)
        key_yt = batch.y * rect_width + xr
        keep = _winner_mask(key_yt, pos, camera_height * rect_width, first=True)
        return FilteredBatch(batch._replace(valid=keep), _dense_rank(key_yt))

    # mean_first_last_per_xy, reference frame_event_filter.py:102-128: one
    # event per (x, y) with t = (t_first + t_last) // 2
    keep_first = _winner_mask(key_xy, pos, n_xy, first=True)
    # the t of the last event at this lane's pixel, gathered through the
    # winning index
    idx1 = torch.where(pos, idx_order + 1, 0)
    put, get = _jax_index(torch.where(pos, key_xy, n_xy), n_xy + 1)
    last_idx = torch.zeros(n_xy + 2, dtype=torch.int32, device=batch.x.device)
    last_idx.scatter_reduce_(0, put, idx1, reduce="amax")
    t_i32 = batch.t.int()
    li = last_idx[get]
    t_last = torch.where(li > 0, t_i32[(li - 1).clamp_min(0).long()], 0)
    t_mean = torch.div(t_i32 + t_last, 2, rounding_mode="floor")
    out = batch._replace(
        valid=keep_first,
        t=torch.where(keep_first, t_mean, batch.t).to(batch.t.dtype),
    )
    return FilteredBatch(out, _dense_rank(key_xy))
