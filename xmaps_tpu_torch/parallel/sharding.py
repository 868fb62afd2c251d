"""Multi-device depth pipeline: data-parallel frames x event-parallel lanes.

Port of ``xmaps_tpu.parallel.sharding``.  As the JAX package, the port is
single-controller: one process holds a ``Mesh`` of devices, one call runs
the whole sharded program and returns every frame's result.  There is no
``shard_map``: each data row's program is issued on its devices in turn
(every launch is asynchronous, so the devices run together), and the
event axis's collectives are explicit functions over one row's
per-device tensors (``pmin``, ``pmax``, ``psum``, ``pmax_u32``,
``all_gather``): each copies to the row's leader (event index 0) with
``Tensor.to(leader, non_blocking=True)``, peer to peer between distinct
cards, ordered after the source's work by PyTorch's cross-device copy,
and reduces there out of place.

- ``data`` axis: frames are independent.  A row runs the group program
  (``ops.frame_pipeline.group_depth_frames``: one launch of kernel 1's
  group entry and one call of the tail's) on its contiguous block of
  frames.  No collective crosses this axis.
- ``event`` axis: shard s holds lanes ``[s * Nl, (s + 1) * Nl)`` of each
  frame, ``Nl = capacity / E``.  The frame's time bounds are the min / max
  over its shards; each shard runs kernel 1's group entry with
  ``index_offset = s * Nl``, so its keys are the frame's, and the E
  partial packed maps combine exactly with an unsigned max on the leader
  (NumPy's last-write-wins, bit for bit), the inlier counts with a sum.
  The tail then runs once, on the leader: JAX replicates it only because
  ``shard_map``'s out spec is replicated, and replicas would only occupy
  the other devices.

A mesh is an explicit list of devices: there is no auto-pick.  A device
may repeat: a repeated device is a *virtual* device, as XLA's forced host
devices are (the JAX tests' 8 virtual CPU devices): ``["cpu"] * 8`` on
the CPU, or one card listed k times, runs the sharded program with its
copies and collectives, and must give the single-device results bit for
bit.  Only distinct devices hold a copy of the tables.

When does the event axis pay on an H100?  (the JAX module's cost model,
with the port's measurements: PERF.md section 6)

  saved  = (1 - 1/E) * N_events * ~0.054 ns   (kernel 1's lanes: 1.55 us
           a ~28k-event frame in a group, experiments/group_scaling.py)
  added  = each extra shard's 4-byte packed map over NVLink,
           4 * H_map * W_map / 450 GB/s, and its zeroing

  -> at E = 2 the event axis pays only above ~0.33 * H_map * W_map events
     a frame: ~158k for the demonstrator's 901 x 532 crop (it has ~28k),
     ~2.2M for the ESL rig's 6.6 Mpx map.

So the default mesh is data-only (``make_mesh(event=1)``), as in JAX; the
event axis is ported for parity.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from xmaps_tpu_torch.config import PipelineConfig
from xmaps_tpu_torch.ops.cuda_events import EventScatterResult, event_disparity_scatter_group
from xmaps_tpu_torch.ops.cuda_tail import Plan, with_colorize_table
from xmaps_tpu_torch.ops.disparity import scale_time, time_bounds
from xmaps_tpu_torch.ops.event_batch import EventBatch
from xmaps_tpu_torch.ops.frame_pipeline import (
    DeviceTables,
    FrameResult,
    filter_events,
    group_depth_frames,
    group_tail,
    scatter_view,
)
from xmaps_tpu_torch.ops.staged import CompactLayout, CompactStagedGroup

__all__ = [
    "Mesh",
    "ShardedBatch",
    "ShardedGroup",
    "make_mesh",
    "make_sharded_pipeline",
    "make_group_sharded_pipeline",
    "shard_batches",
    "shard_staged_group",
    "replicate",
    "split_frames",
    "pmin",
    "pmax",
    "psum",
    "pmax_u32",
    "all_gather",
]

#: the int32 view of a uint32 word's sign bit: ``w ^ SIGN`` maps the
#: unsigned order of packed words onto the signed order of int32
SIGN = -(2**31)


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ('data', 'event') grid of devices (``make_mesh``)."""

    #: (data, event) object array of ``torch.device``, each with its index
    devices: np.ndarray

    @property
    def shape(self) -> dict:
        d, e = self.devices.shape
        return {"data": d, "event": e}

    @property
    def distinct(self) -> list:
        """The mesh's devices, each once, in row-major order."""
        return list(dict.fromkeys(self.devices.flat))

    @property
    def virtual(self) -> bool:
        """Whether a device repeats (virtual devices)."""
        return len(self.distinct) < self.devices.size

    def key(self) -> tuple:
        """(shape, devices): equal for meshes of the same devices."""
        return tuple(self.devices.shape), tuple(str(d) for d in self.devices.flat)


def _mesh_device(device) -> torch.device:
    """``device`` as an indexed ``torch.device`` that exists: "cpu", or
    "cuda[:i]" with i below ``torch.cuda.device_count()``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device!r} (cpu or cuda[:i])")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = dev.index if dev.index is not None else (torch.cuda.current_device() if count else 0)
    if index >= count:
        raise ValueError(
            f"make_mesh: device {device!r} is not there ({count} CUDA devices visible); "
            "pass 'cpu' explicitly to run on the CPU")
    return torch.device("cuda", index)


def make_mesh(devices: Sequence, data: Optional[int] = None, event: int = 1) -> Mesh:
    """A ('data', 'event') mesh over ``devices`` (required: no auto-pick),
    row-major: row r holds ``devices[r * event:(r + 1) * event]``.
    ``data`` defaults to ``len(devices) // event``; ``data * event`` must
    equal the number of devices.  A device may repeat (a virtual device,
    see the module docstring); all must be of one type."""
    devs = [_mesh_device(d) for d in devices]
    n = len(devs)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"make_mesh: CPU and CUDA devices in one mesh: {devs}")
    if event < 1:
        raise ValueError(f"make_mesh: event {event} < 1")
    if data is None:
        data = n // event
    if data < 1 or data * event != n:
        raise ValueError(f"make_mesh: {data} x {event} != {n} devices")
    grid = np.empty((data, event), dtype=object)
    for i, d in enumerate(devs):
        grid[i // event, i % event] = d
    return Mesh(grid)


# -- collectives over one event group's per-device tensors -------------------


def _to(parts, leader):
    return [p.to(leader, non_blocking=True) for p in parts]


def pmin(parts: Sequence[torch.Tensor], leader) -> torch.Tensor:
    """Elementwise min of the shards' tensors, on ``leader``."""
    return functools.reduce(torch.minimum, _to(parts, leader))


def pmax(parts: Sequence[torch.Tensor], leader) -> torch.Tensor:
    """Elementwise max of the shards' tensors, on ``leader``."""
    return functools.reduce(torch.maximum, _to(parts, leader))


def psum(parts: Sequence[torch.Tensor], leader) -> torch.Tensor:
    """Elementwise sum of the shards' tensors, on ``leader``."""
    return functools.reduce(torch.add, _to(parts, leader))


def pmax_u32(parts: Sequence[torch.Tensor], leader) -> torch.Tensor:
    """Elementwise *unsigned* max of int32 tensors holding uint32 words
    (the packed disparity maps: keys reach 2**31 and read negative as
    int32), on ``leader``: the sign bit flipped before and after a signed
    max.  Out of place: on a virtual mesh ``.to(leader)`` returns a shard's
    own tensor, which an in-place reduce would overwrite."""
    flipped = [p ^ SIGN for p in _to(parts, leader)]
    return functools.reduce(torch.maximum, flipped) ^ SIGN


def all_gather(parts: Sequence[torch.Tensor], leader, dim: int = -1) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` on ``leader``
    (JAX's tiled ``all_gather``)."""
    return torch.cat(_to(parts, leader), dim=dim)


# -- replicas, placement -------------------------------------------------------


def replicate(tables: DeviceTables, plan: Plan, device) -> tuple[DeviceTables, Plan]:
    """``tables`` and ``plan`` on ``device`` (as ``XMapsDepthEngine.to``):
    the same tensors where they already lie there; the plan's colorize
    table built there on CUDA, dropped on the CPU."""
    t = tables.to(device)
    return t, with_colorize_table(plan, t)


def _replicas(tables, plan, mesh: Mesh, cache: Optional[dict] = None) -> dict:
    """{device: (tables, plan)} for each distinct device of the mesh, taken
    from and added to ``cache`` where one is given."""
    cache = {} if cache is None else cache
    for dev in mesh.distinct:
        if dev not in cache:
            cache[dev] = replicate(tables, plan, dev)
    return {dev: cache[dev] for dev in mesh.distinct}


class ShardedBatch(NamedTuple):
    """A stacked ``EventBatch`` of B frames placed on a mesh
    (``shard_batches``): ``shards[r][s]`` holds frames ``[r * B/data,
    (r + 1) * B/data)`` and lanes ``[s * Nl, (s + 1) * Nl)`` on
    ``mesh.devices[r, s]``, its ``count`` the frames' whole counts."""

    mesh: Mesh
    shards: tuple


_LANES = ("x", "y", "t", "p", "valid")


def shard_batches(batches: Sequence[EventBatch], mesh: Mesh, cfg: PipelineConfig) -> ShardedBatch:
    """Stack one-frame ``EventBatch``es (capacity ``cfg.event_capacity``,
    all on one device) along a leading frame axis and place the blocks on
    the mesh: B frames over ``data`` rows (``B % data == 0``), the lanes
    over ``event`` shards (``capacity % event == 0``), one host-or-device
    copy a shard and field."""
    data, ev = mesh.devices.shape
    b, cap = len(batches), cfg.event_capacity
    if b == 0 or b % data:
        raise ValueError(f"shard_batches: {b} frames over {data} data rows")
    if cap % ev:
        raise ValueError(f"shard_batches: capacity {cap} over {ev} event shards")
    if any(x.capacity != cap for x in batches):
        raise ValueError(f"shard_batches: a batch's capacity is not {cap}")
    stacked = EventBatch(*(torch.stack(a) for a in zip(*batches)))
    rows, lanes = b // data, cap // ev
    shards = []
    for r in range(data):
        fr = slice(r * rows, (r + 1) * rows)
        row = []
        for s, dev in enumerate(mesh.devices[r]):
            ln = slice(s * lanes, (s + 1) * lanes)
            row.append(EventBatch(
                *(getattr(stacked, k)[fr, ln].contiguous().to(dev) for k in _LANES),
                count=stacked.count[fr].to(dev)))
        shards.append(tuple(row))
    return ShardedBatch(mesh, tuple(shards))


def split_frames(n: int, data: int) -> list[slice]:
    """The contiguous blocks of ``n`` frames over ``data`` rows: ``ceil(n /
    data)`` frames a row, the last non-empty block possibly short and the
    rows after it empty (JAX pads the list with empty frames to a multiple
    of the data size, since its program has one shape; the port runs each
    row's block as it is)."""
    size = -(-n // data)
    return [slice(min(r * size, n), min((r + 1) * size, n)) for r in range(data)]


class ShardedGroup(NamedTuple):
    """F frames staged for ``make_group_sharded_pipeline``
    (``shard_staged_group``): ``rows[r]`` is the block of row r staged on
    its device (``XMapsDepthEngine.stage_group``), None for an empty
    block."""

    mesh: Mesh
    rows: tuple


def shard_staged_group(
    frames: Sequence, mesh: Mesh, stage_group: Callable, *, index: Optional[Sequence] = None
) -> ShardedGroup:
    """The frames (structured event arrays) split into contiguous blocks
    over the mesh's ``data`` rows (``split_frames``; event == 1), each
    block staged on its row's device by ``stage_group(block, device=)``:
    one host buffer and one copy a row where the 1-word layout fits
    (``XMapsDepthEngine.stage_group``).  ``index``: the indices of the
    frames each row stages, in place of the blocks (a subset of each
    block: ``XMapsDepthEngine.process_frames_sharded`` stages a list of
    mixed time kinds once a kind)."""
    if mesh.shape["event"] != 1:
        raise ValueError("shard_staged_group: the group program is data-parallel only "
                         "(use make_sharded_pipeline for event-sharded meshes)")
    if index is None:
        index = [range(sl.start, sl.stop) for sl in split_frames(len(frames), mesh.shape["data"])]
    rows = []
    for ids, dev in zip(index, mesh.devices[:, 0], strict=True):
        block = [frames[i] for i in ids]
        rows.append(stage_group(block, device=dev) if block else None)
    return ShardedGroup(mesh, tuple(rows))


# -- the pipelines -------------------------------------------------------------


def _event_sharded_row(
    shards: Sequence[EventBatch],
    devs: Sequence[torch.device],
    replicas: dict,
    cfg: PipelineConfig,
) -> FrameResult:
    """One data row's frames over its E event shards (JAX's
    ``_frame_event_sharded``): the result on the leader ``devs[0]``."""
    leader = devs[0]
    tables, plan = replicas[leader]
    view = scatter_view(cfg, plan)
    lanes = shards[0].x.shape[-1]
    offsets = [s * lanes for s in range(len(shards))]
    priorities = [None] * len(shards)
    if cfg.frame_filter != "none":
        # a dedup filter needs the frame's global winners and raster ranks:
        # gather the frame's lanes onto the leader, filter the whole frames
        # there, hand each shard its slice of the batch and of the global
        # priority (which replaces the lane index: no offset)
        full = EventBatch(*(all_gather([getattr(s, k) for s in shards], leader) for k in _LANES),
                          count=shards[0].count.to(leader))
        fb, prio = filter_events(full, tables, cfg)

        def part(a, s, dev):
            return a[:, s * lanes:(s + 1) * lanes].contiguous().to(dev)

        shards = [EventBatch(*(part(getattr(fb, k), s, dev) for k in _LANES), count=sh.count)
                  for s, (sh, dev) in enumerate(zip(shards, devs))]
        priorities = [part(prio, s, dev) for s, dev in enumerate(devs)]
        offsets = [0] * len(shards)
    # each frame's time window over all its shards
    lo, hi = zip(*(time_bounds(s.t, s.valid) for s in shards))
    t_min, t_max = pmin(lo, leader), pmax(hi, leader)
    parts = []
    for sh, dev, prio, off in zip(shards, devs, priorities, offsets):
        t_bin = scale_time(sh.t, sh.valid, cfg.t_px_scale,
                           bounds=(t_min.to(dev), t_max.to(dev)))
        parts.append(event_disparity_scatter_group(
            sh, t_bin, replicas[dev][0], **view, priority=prio, index_offset=off))
    ev = EventScatterResult(pmax_u32([p.packed_map for p in parts], leader),
                            psum([p.num_inliers for p in parts], leader))
    return group_tail(ev, tables, cfg, plan)


def make_sharded_pipeline(
    cfg: PipelineConfig,
    tables: DeviceTables,
    mesh: Mesh,
    plan: Plan,
) -> Callable[[ShardedBatch], FrameResult]:
    """The multi-device pipeline over stacked frame batches.

    Input: a ``ShardedBatch`` of B frames on ``mesh`` (``shard_batches``;
    ``B % data == 0``, capacity ``% event == 0``).  Output: one
    ``FrameResult`` with leading axis B (``num_inliers`` (B,)) on the
    mesh's first device, frame b bit-equal to ``depth_frame`` of frame b:
    with more than one data row the rows' outputs are copied there (the
    port has no tensor that spans devices; on distinct cards that is a
    peer copy of every frame's outputs).
    ``tables`` and ``plan`` (the engine's, on any device) are copied once
    to each distinct device of the mesh.

    With event == 1 each row runs the group program on its frames (kernel
    1's group entry and the tail's, one call each, on its device); with
    event > 1 each row's shards run kernel 1 with their lane offset, and
    the row's leader combines them and runs the tail (module docstring).
    """
    data, ev = mesh.devices.shape
    if cfg.event_capacity % ev:
        raise ValueError(f"make_sharded_pipeline: capacity {cfg.event_capacity} over {ev} "
                         "event shards")
    replicas = _replicas(tables, plan, mesh)
    out_dev = mesh.devices[0, 0]

    def pipeline(batch: ShardedBatch) -> FrameResult:
        if batch.mesh.key() != mesh.key():
            raise ValueError("make_sharded_pipeline: the batch is placed on another mesh")
        rows = []
        for r in range(data):
            devs = list(mesh.devices[r])
            if ev == 1:
                t, p = replicas[devs[0]]
                rows.append(group_depth_frames(batch.shards[r][0], t, cfg, p))
            else:
                rows.append(_event_sharded_row(batch.shards[r], devs, replicas, cfg))
        if len(rows) == 1:  # already on the first device: no gather copy
            return rows[0]
        return FrameResult(*(torch.cat([a.to(out_dev, non_blocking=True) for a in field])
                             for field in zip(*rows)))

    return pipeline


def make_group_sharded_pipeline(
    cfg: PipelineConfig,
    tables: DeviceTables,
    mesh: Mesh,
    plan: Plan,
    *,
    layout: Optional[CompactLayout] = None,
    cache: Optional[dict] = None,
) -> Callable[..., list]:
    """The data-parallel group pipeline: the engine's ``process_frames``
    program (1-word staged rows where they fit, else the stacked batch,
    any filter) on each row of the mesh's ``data`` axis (event == 1).

    Input: a ``ShardedGroup`` (``shard_staged_group``) and the call's
    ``display_only`` / ``display_packed``.  Output: one ``FrameResult`` a
    non-empty row, its fields with a leading axis of the row's frames on
    the row's device (the port has no tensor that spans devices), in row
    order; each frame bit-equal to ``process_frame``.  ``layout``: the
    1-word staging's (``XMapsDepthEngine.compact_layout``); ``cache``: a
    dict, filled here, that keeps the copies of ``tables`` and ``plan``
    across pipelines (the engine's, one a distinct device).
    """
    if mesh.shape["event"] != 1:
        raise ValueError("make_group_sharded_pipeline: the group program is data-parallel "
                         "only (use make_sharded_pipeline for event-sharded meshes)")
    replicas = _replicas(tables, plan, mesh, cache)

    def pipeline(group: ShardedGroup, *, display_only: bool = False,
                 display_packed: bool = False) -> list:
        if group.mesh.key() != mesh.key():
            raise ValueError("make_group_sharded_pipeline: the group is staged on another mesh")
        out = []
        for staged, dev in zip(group.rows, mesh.devices[:, 0]):
            if staged is None:
                continue
            if isinstance(staged, CompactStagedGroup):
                row_dev = staged.word.device
            else:
                row_dev = staged.x.device
            if row_dev != dev:
                raise ValueError(f"make_group_sharded_pipeline: a row staged on {row_dev}, "
                                 f"not on its device {dev}")
            t, p = replicas[dev]
            out.append(group_depth_frames(staged, t, cfg, p, layout=layout,
                                          display_only=display_only,
                                          display_packed=display_packed))
        return out

    return pipeline
