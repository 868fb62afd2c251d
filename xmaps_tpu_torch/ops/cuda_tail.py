"""Kernel 2 and 3 wrappers: the dense per-frame image tail.

- ``tail_projector``: packed crop map -> unpack -> 7x7 max dilate -> nearest
  remap to the projector -> depth -> u8 -> TURBO.  On CUDA it runs
  ``csrc/tail.cu:tail_projector`` (replacing the TPU kernel ``pallas_tail``)
  as two launches on the current stream: ``tail_dilate`` (the 7x7 max of
  the crop in column strips into a uint16 scratch) and
  ``tail_remap_colorize`` (4 projector pixels a thread, the maps read 8
  bytes at a time, each pixel's depth and colour read from the plan's
  colorize table), counted as one launch of ``tail_projector``; on CPU it
  runs the plain chain: ``dilate_max`` on the crop, ``remap_nearest_i16``,
  then ``ops.image_tail``.
- ``colorize_camera``: the camera view, packed map -> unpack -> depth -> u8
  -> TURBO (replacing ``pallas_colorize``); on CUDA 4 pixels a thread
  through the colorize table.

Both results depend on the disparity (``packed & (PACK - 1)``, or the
dilated one) alone, so on CUDA the engine's plan of either view holds the
epilogue of all PACK disparities (``build_colorize_table``, one launch of
``csrc/tail.cu:colorize_table`` per engine and card; ``with_colorize_table``)
and the kernels read it in place of the divisions; on CPU the plan holds no
table and the plain chain runs.

The plans keep only what the GPU needs: the crop of the rectified frame
that the projector remap samples (plus the 3-px dilate halo) and the
scalars.  The TPU plan's band tables and tile ladder are not needed.

Each function returns (frame, depth, disp): frame is (H, W, 3) uint8, or
with ``packed_bgr`` one (H, W) int32 packed-BGR plane (B | G<<8 | R<<16);
depth and disp are float32 planes, or None unless ``emit_aux``.

``tail_projector_group`` and ``colorize_camera_group`` take F frames' maps
stacked as (F, H, W) and return each output with a leading frame axis, in
one call of the kernel (kernel 2: its dilate with the frame on a grid axis,
then one remap pass that reads the projector maps once for the F frames;
kernel 3: one launch over the F * H * W pixels).  Their plain versions run
the one-frame plain version on each frame and stack the results.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from xmaps_tpu_torch.ops import _build
from xmaps_tpu_torch.ops.image_tail import (
    clip_normalize_u8,
    colorize_turbo,
    colorize_turbo_packed,
    dilate_max,
    disparity_to_depth,
    remap_nearest_i16,
)
from xmaps_tpu_torch.ops.scatter import PACK, unpack_disp

__all__ = [
    "Plan",
    "TailPlan",
    "build_tail_plan",
    "CamTailPlan",
    "with_colorize_table",
    "build_colorize_table",
    "colorize_table_plain",
    "tail_projector",
    "tail_projector_plain",
    "colorize_camera",
    "colorize_camera_plain",
    "tail_projector_group",
    "tail_projector_group_plain",
    "colorize_camera_group",
    "colorize_camera_group_plain",
]

#: a group's frames: kernel 2's dilate takes the frame from a grid axis
#: (65535 at most)
MAX_GROUP_FRAMES = 65535
#: kernel 2's group outputs hold a frame every multiple of this many pixels,
#: so each frame's 16-byte stores (and 3-byte BGR's 4-byte words) stay aligned
GROUP_STRIDE_PX = 8


@dataclass(frozen=True)
class TailPlan:
    """Projector-view tail: the crop and the scalars.

    The kernel only reads rect pixels the projector remap samples plus the
    3-px dilate halo, so scatter targets outside the crop cannot influence
    any output pixel and cropping is bit-exact.
    """

    full_H: int  # full rectified image height
    full_W: int
    crop_row0: int  # crop origin in full-rect coordinates
    crop_col0: int
    H: int  # crop height
    W: int  # crop width
    p03: float
    z_near: float
    z_far: float
    #: (bgr, depth) of ``with_colorize_table``, on the card; None on the CPU
    table: Optional[tuple] = dataclasses.field(default=None, compare=False, repr=False)


def build_tail_plan(
    proj_mapx_i16: np.ndarray,
    proj_mapy_i16: np.ndarray,
    rect_height: int,
    rect_width: int,
    p03: float,
    z_near: float,
    z_far: float,
) -> TailPlan:
    """The crop of ``xmaps_tpu.ops.pallas_tail.build_tail_plan``: the
    sampled window of the rect frame plus the dilate halo, clipped to it."""
    X = proj_mapx_i16.astype(np.int64)
    Y = proj_mapy_i16.astype(np.int64)
    inb = (X >= 0) & (X < rect_width) & (Y >= 0) & (Y < rect_height)
    if inb.any():
        r_lo = max(int(Y[inb].min()) - 3, 0)
        r_hi = min(int(Y[inb].max()) + 3, rect_height - 1)
        c_lo = max(int(X[inb].min()) - 3, 0)
        c_hi = min(int(X[inb].max()) + 3, rect_width - 1)
    else:
        r_lo, r_hi, c_lo, c_hi = 0, rect_height - 1, 0, rect_width - 1
    return TailPlan(
        full_H=rect_height, full_W=rect_width,
        crop_row0=r_lo, crop_col0=c_lo,
        H=r_hi - r_lo + 1, W=c_hi - c_lo + 1,
        p03=float(p03), z_near=float(z_near), z_far=float(z_far),
    )


@dataclass(frozen=True)
class CamTailPlan:
    """Camera-view tail: the camera frame, the scalars and, on CUDA, the
    colorize table of ``with_colorize_table``."""

    H: int
    W: int
    p03: float
    z_near: float
    z_far: float
    #: (bgr, depth): (PACK,) int32 packed BGR and float32 depth of every
    #: disparity, on the card; None on the CPU
    table: Optional[tuple] = dataclasses.field(default=None, compare=False, repr=False)


Plan = Union[TailPlan, CamTailPlan]


def _check(kernel, dev, **tensors):
    for name, (a, dtype, shape) in tensors.items():
        if (
            a.device != dev
            or a.dtype != dtype
            or tuple(a.shape) != tuple(shape)
            or not a.is_contiguous()
        ):
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {dtype} tensor of shape "
                f"{tuple(shape)} on {dev}, got {a.dtype} {tuple(a.shape)} on {a.device}"
            )


def _outputs(shape, dev, emit_aux, packed_bgr):
    if packed_bgr and emit_aux:
        raise ValueError("packed_bgr is display-only (emit_aux=False)")
    frame = (
        torch.empty(shape, dtype=torch.int32, device=dev)
        if packed_bgr
        else torch.empty((*shape, 3), dtype=torch.uint8, device=dev)
    )
    depth = torch.empty(shape, dtype=torch.float32, device=dev) if emit_aux else None
    disp = torch.empty(shape, dtype=torch.float32, device=dev) if emit_aux else None
    ptrs = (
        frame.data_ptr() if packed_bgr else None,
        None if packed_bgr else frame.data_ptr(),
        depth.data_ptr() if emit_aux else None,
        disp.data_ptr() if emit_aux else None,
    )
    return (frame, depth, disp), ptrs


def _group_outputs(frames, shape, dev, emit_aux, packed_bgr):
    """``_outputs`` with a leading frame axis, each frame at a multiple of
    ``GROUP_STRIDE_PX`` pixels: the (F, *shape[, 3]) results are views of
    padded rows where H * W is not such a multiple.  Returns (outputs,
    pointers, the frame stride in pixels)."""
    if packed_bgr and emit_aux:
        raise ValueError("packed_bgr is display-only (emit_aux=False)")
    n = shape[0] * shape[1]
    stride = -(-n // GROUP_STRIDE_PX) * GROUP_STRIDE_PX

    def rows(dtype, k=1):
        a = torch.empty((frames, k * stride), dtype=dtype, device=dev)
        return a, a[:, :k * n].unflatten(1, (*shape, 3) if k == 3 else shape)

    frame = rows(torch.int32) if packed_bgr else rows(torch.uint8, 3)
    depth = rows(torch.float32) if emit_aux else (None, None)
    disp = rows(torch.float32) if emit_aux else (None, None)
    ptrs = (
        frame[0].data_ptr() if packed_bgr else None,
        None if packed_bgr else frame[0].data_ptr(),
        depth[0].data_ptr() if emit_aux else None,
        disp[0].data_ptr() if emit_aux else None,
    )
    return (frame[1], depth[1], disp[1]), ptrs, stride


def _stack_frames(outs):
    """Per-frame (frame, depth, disp) triples -> one triple of stacks."""
    return tuple(None if parts[0] is None else torch.stack(parts) for parts in zip(*outs))


def _table(kernel, plan: Plan, dev):
    """The plan's (bgr, depth) colorize table, checked to lie on ``dev``."""
    if plan.table is None or plan.table[0].device != dev:
        raise ValueError(
            f"{kernel}: the plan holds no colorize table on {dev} "
            "(build it with with_colorize_table)")
    bgr_table, depth_table = plan.table
    _check(kernel, dev, bgr_table=(bgr_table, torch.int32, (PACK,)),
           depth_table=(depth_table, torch.float32, (PACK,)))
    return bgr_table, depth_table


def _projector_maps(kernel, tables, dev):
    """(Hp, Wp) of the projector maps, checked 16-byte aligned on ``dev``."""
    Hp, Wp = tables.proj_mapx_i16.shape
    _check(kernel, dev,
           proj_mapx=(tables.proj_mapx_i16, torch.int16, (Hp, Wp)),
           proj_mapy=(tables.proj_mapy_i16, torch.int16, (Hp, Wp)))
    for name in ("proj_mapx_i16", "proj_mapy_i16"):
        if getattr(tables, name).data_ptr() % 16:
            raise ValueError(
                f"{kernel}: {name} must be 16-byte aligned (the kernel's vector loads)")
    return Hp, Wp


def _group_frames(kernel, maps, shape) -> int:
    if maps.dim() != 3 or tuple(maps.shape[1:]) != tuple(shape) or not (
            1 <= maps.shape[0] <= MAX_GROUP_FRAMES):
        raise ValueError(f"{kernel}: maps must be (F, {shape[0]}, {shape[1]}) with 1 <= F <= "
                         f"{MAX_GROUP_FRAMES}, got {tuple(maps.shape)}")
    return maps.shape[0]


def _plain_epilogue(disp, p03, z_near, z_far, emit_aux, packed_bgr):
    if packed_bgr and emit_aux:
        raise ValueError("packed_bgr is display-only (emit_aux=False)")
    depth = disparity_to_depth(disp, p03)
    u8 = clip_normalize_u8(depth, z_near, z_far)
    frame = colorize_turbo_packed(u8) if packed_bgr else colorize_turbo(u8)
    if emit_aux:
        return frame, depth, disp
    return frame, None, None


def tail_projector_plain(
    packed_crop: torch.Tensor,
    tables,
    plan: TailPlan,
    *,
    emit_aux: bool = True,
    packed_bgr: bool = False,
):
    """Plain PyTorch version of ``tail_projector`` (any device): dilate
    the crop, remap with the crop-shifted projector maps (out of the rect
    frame -> -1 -> 0), then the image_tail chain."""
    X = tables.proj_mapx_i16.int()
    Y = tables.proj_mapy_i16.int()
    inb = (X >= 0) & (X < plan.full_W) & (Y >= 0) & (Y < plan.full_H)
    dil = dilate_max(unpack_disp(packed_crop), 7)
    disp = remap_nearest_i16(
        dil,
        torch.where(inb, X - plan.crop_col0, -1),
        torch.where(inb, Y - plan.crop_row0, -1),
    )
    return _plain_epilogue(
        disp, tables.p03, plan.z_near, plan.z_far, emit_aux, packed_bgr
    )


def colorize_camera_plain(
    packed: torch.Tensor,
    tables,
    plan: CamTailPlan,
    *,
    emit_aux: bool = True,
    packed_bgr: bool = False,
):
    """Plain PyTorch version of ``colorize_camera`` (any device)."""
    return _plain_epilogue(
        unpack_disp(packed), tables.p03, plan.z_near, plan.z_far,
        emit_aux, packed_bgr,
    )


def colorize_table_plain(tables, plan: Plan):
    """Plain PyTorch version of ``build_colorize_table`` (any device): the
    epilogue of the disparities 0 .. PACK - 1."""
    d = torch.arange(PACK, dtype=torch.float32, device=tables.turbo_lut.device)
    bgr, _, _ = _plain_epilogue(d, tables.p03, plan.z_near, plan.z_far,
                                emit_aux=False, packed_bgr=True)
    return bgr, disparity_to_depth(d, tables.p03)


def build_colorize_table(tables, plan: Plan):
    """(bgr, depth): the packed BGR (int32) and depth (float32) of every
    disparity 0 .. PACK - 1, on ``tables.turbo_lut``'s CUDA device, in one
    launch of ``colorize_table`` (the IEEE epilogue of ``plan.p03``,
    ``z_near`` and ``z_far``, so each entry equals the plain chain of its
    disparity bit for bit).  Only the card holds a table: on the CPU
    ``with_colorize_table`` builds none and kernels 2 and 3 run their plain
    chains, so any other device raises."""
    lut = tables.turbo_lut
    dev = lut.device
    if dev.type != "cuda":
        raise ValueError(f"colorize_table: the table is built on CUDA only, not on {dev}")
    _check("colorize_table", dev, lut=(lut, torch.int32, (256,)))
    bgr = torch.empty(PACK, dtype=torch.int32, device=dev)
    depth = torch.empty(PACK, dtype=torch.float32, device=dev)
    _build.launch(
        dev, "colorize_table", "colorize_table",
        lut.data_ptr(), plan.p03, plan.z_near, plan.z_far, bgr.data_ptr(),
        depth.data_ptr(),
    )
    return bgr, depth


def with_colorize_table(plan: Plan, tables) -> Plan:
    """``plan`` (either view's) holding the colorize table on ``tables``'
    device: built there on CUDA (kept where the plan already holds one
    there), none on CPU."""
    dev = tables.turbo_lut.device
    if dev.type == "cpu":
        return dataclasses.replace(plan, table=None)
    if plan.table is not None and plan.table[0].device == dev:
        return plan
    return dataclasses.replace(plan, table=build_colorize_table(tables, plan))


def tail_projector(
    packed_crop: torch.Tensor,
    tables,
    plan: TailPlan,
    *,
    emit_aux: bool = True,
    packed_bgr: bool = False,
):
    """(H, W) int32 packed crop map -> projector-view (frame, depth, disp).

    ``tables``: ``ops.frame_pipeline.DeviceTables`` (projector maps, p03,
    TURBO LUT) on the map's device.  On CUDA the plan must hold the
    colorize table on the map's device (``with_colorize_table``; the
    engine's plan does) and the projector maps must be 16-byte aligned: a
    ``ValueError`` otherwise.
    """
    dev = packed_crop.device
    if dev.type == "cpu":
        return tail_projector_plain(
            packed_crop, tables, plan, emit_aux=emit_aux, packed_bgr=packed_bgr
        )
    if dev.type != "cuda":
        raise ValueError(f"tail_projector: unsupported device {dev}")
    _check("tail_projector", dev,
           packed_crop=(packed_crop, torch.int32, (plan.H, plan.W)))
    bgr_table, depth_table = _table("tail_projector", plan, dev)
    Hp, Wp = _projector_maps("tail_projector", tables, dev)
    outs, ptrs = _outputs((Hp, Wp), dev, emit_aux, packed_bgr)
    dil = torch.empty((plan.H, plan.W), dtype=torch.uint16, device=dev)
    # kernel 2's one C entry, at F = 1 (one frame's outputs, stride Hp * Wp)
    _build.launch(
        dev, "tail_projector", "tail_projector_group",
        packed_crop.data_ptr(), 1, plan.H, plan.W, plan.crop_row0, plan.crop_col0,
        plan.full_H, plan.full_W, dil.data_ptr(),
        tables.proj_mapx_i16.data_ptr(), tables.proj_mapy_i16.data_ptr(), Hp, Wp, Hp * Wp,
        bgr_table.data_ptr(), depth_table.data_ptr(), *ptrs,
    )
    return outs


def colorize_camera(
    packed: torch.Tensor,
    tables,
    plan: CamTailPlan,
    *,
    emit_aux: bool = True,
    packed_bgr: bool = False,
):
    """(H, W) int32 packed camera-view map -> (frame, depth, disp).

    On CUDA the plan must hold the colorize table on the map's device
    (``with_colorize_table``; the engine's plan does) and the map must be
    16-byte aligned: a ``ValueError`` otherwise.
    """
    dev = packed.device
    if dev.type == "cpu":
        return colorize_camera_plain(
            packed, tables, plan, emit_aux=emit_aux, packed_bgr=packed_bgr
        )
    if dev.type != "cuda":
        raise ValueError(f"colorize_camera: unsupported device {dev}")
    bgr_table, depth_table = _table("colorize_camera", plan, dev)
    _check("colorize_camera", dev, packed=(packed, torch.int32, (plan.H, plan.W)))
    if packed.data_ptr() % 16:
        raise ValueError("colorize_camera: packed must be 16-byte aligned (the kernel reads int4)")
    outs, ptrs = _outputs((plan.H, plan.W), dev, emit_aux, packed_bgr)
    _build.launch(
        dev, "colorize_camera", "colorize_camera",
        packed.data_ptr(), plan.H * plan.W, bgr_table.data_ptr(), depth_table.data_ptr(),
        *ptrs,
    )
    return outs


def tail_projector_group_plain(
    packed_crops: torch.Tensor,
    tables,
    plan: TailPlan,
    *,
    emit_aux: bool = True,
    packed_bgr: bool = False,
):
    """Plain PyTorch version of ``tail_projector_group`` (any device): the
    one-frame plain version on each crop, stacked."""
    _group_frames("tail_projector_group", packed_crops, (plan.H, plan.W))
    return _stack_frames([
        tail_projector_plain(crop, tables, plan, emit_aux=emit_aux, packed_bgr=packed_bgr)
        for crop in packed_crops
    ])


def tail_projector_group(
    packed_crops: torch.Tensor,
    tables,
    plan: TailPlan,
    *,
    emit_aux: bool = True,
    packed_bgr: bool = False,
):
    """(F, H, W) int32 packed crop maps -> F projector-view (frame, depth,
    disp), each output (F, Hp, Wp[, 3]), frame f equal to
    ``tail_projector`` of crop f: one call of kernel 2 (its dilate over the
    F crops, then one remap pass that reads the projector maps once for
    the F frames)."""
    f = _group_frames("tail_projector_group", packed_crops, (plan.H, plan.W))
    dev = packed_crops.device
    if dev.type == "cpu":
        return tail_projector_group_plain(
            packed_crops, tables, plan, emit_aux=emit_aux, packed_bgr=packed_bgr
        )
    if dev.type != "cuda":
        raise ValueError(f"tail_projector_group: unsupported device {dev}")
    _check("tail_projector_group", dev,
           packed_crops=(packed_crops, torch.int32, (f, plan.H, plan.W)))
    bgr_table, depth_table = _table("tail_projector_group", plan, dev)
    Hp, Wp = _projector_maps("tail_projector_group", tables, dev)
    outs, ptrs, stride = _group_outputs(f, (Hp, Wp), dev, emit_aux, packed_bgr)
    dil = torch.empty((f, plan.H, plan.W), dtype=torch.uint16, device=dev)
    _build.launch(
        dev, "tail_projector_group", "tail_projector_group",
        packed_crops.data_ptr(), f, plan.H, plan.W, plan.crop_row0, plan.crop_col0,
        plan.full_H, plan.full_W, dil.data_ptr(),
        tables.proj_mapx_i16.data_ptr(), tables.proj_mapy_i16.data_ptr(), Hp, Wp, stride,
        bgr_table.data_ptr(), depth_table.data_ptr(), *ptrs,
    )
    return outs


def colorize_camera_group_plain(
    packed: torch.Tensor,
    tables,
    plan: CamTailPlan,
    *,
    emit_aux: bool = True,
    packed_bgr: bool = False,
):
    """Plain PyTorch version of ``colorize_camera_group`` (any device): the
    one-frame plain version on each map, stacked."""
    _group_frames("colorize_camera_group", packed, (plan.H, plan.W))
    return _stack_frames([
        colorize_camera_plain(m, tables, plan, emit_aux=emit_aux, packed_bgr=packed_bgr)
        for m in packed
    ])


def colorize_camera_group(
    packed: torch.Tensor,
    tables,
    plan: CamTailPlan,
    *,
    emit_aux: bool = True,
    packed_bgr: bool = False,
):
    """(F, H, W) int32 packed camera-view maps -> F (frame, depth, disp),
    each output (F, H, W[, 3]), frame f equal to ``colorize_camera`` of map
    f: kernel 3 is a pure pass over pixels, so the group is one launch over
    the F * H * W pixels of the contiguous maps."""
    f = _group_frames("colorize_camera_group", packed, (plan.H, plan.W))
    dev = packed.device
    if dev.type == "cpu":
        return colorize_camera_group_plain(
            packed, tables, plan, emit_aux=emit_aux, packed_bgr=packed_bgr
        )
    if dev.type != "cuda":
        raise ValueError(f"colorize_camera_group: unsupported device {dev}")
    bgr_table, depth_table = _table("colorize_camera_group", plan, dev)
    _check("colorize_camera_group", dev, packed=(packed, torch.int32, (f, plan.H, plan.W)))
    if packed.data_ptr() % 16:
        raise ValueError(
            "colorize_camera_group: packed must be 16-byte aligned (the kernel reads int4)")
    n = f * plan.H * plan.W
    if n >= 2**31:
        raise ValueError(f"colorize_camera_group: {n} pixels (at most 2**31 - 1)")
    outs, ptrs = _outputs((f, plan.H, plan.W), dev, emit_aux, packed_bgr)
    _build.launch(
        dev, "colorize_camera_group", "colorize_camera",
        packed.data_ptr(), n, bgr_table.data_ptr(), depth_table.data_ptr(),
        *ptrs,
    )
    return outs
