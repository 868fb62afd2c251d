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
gathers clamp it.  On CUDA tensors these are a stable sort, two
``scatter_reduce_`` and a few gathers; kernel 1 (``ops.cuda_events``)
takes the priority.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from xmaps_tpu_torch.ops.event_batch import EventBatch

__all__ = ["FILTER_NAMES", "FilteredBatch", "apply_frame_filter", "check_filter_name"]

#: the frame dedup filters, in the E key's cycle order
FILTER_NAMES = (
    "none",
    "first_per_yt",
    "first_per_xy",
    "last_per_xy",
    "mean_first_last_per_xy",
)


class FilteredBatch(NamedTuple):
    batch: EventBatch
    #: (N,) int32 per-lane scatter priority; the dense raster RANK for the
    #: dedup filters, the event order for NoFilter (see _dense_rank)
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


def apply_frame_filter(
    batch: EventBatch,
    x_rect_i16: Optional[torch.Tensor],
    *,
    name: str,
    camera_width: int,
    camera_height: int,
    rect_width: int,
) -> FilteredBatch:
    """Apply one of the 5 reference dedup strategies to a padded batch.

    Args:
        batch: the frame's padded events.
        x_rect_i16: per-lane rectified x (int32), the ``xp_i16`` the
            reference passes to filters (depth_reprojection_pipe.py:131);
            read only by first_per_yt, and may be None for the others.
        name: one of FILTER_NAMES.
    """
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
