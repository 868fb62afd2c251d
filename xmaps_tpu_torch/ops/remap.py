"""Static-index remap: ``dest = where(inb, src[yi, xi], 0)`` (kernel B).

Port of ``xmaps_tpu.ops.pallas_remap``.  The offline eval rectifies each
camera scan on the device through integer index maps precomputed on the
host with the reference's rounding (``build_remap_indices``: ``np.rint``,
round half to even, and BORDER_CONSTANT), and gathers the rectified
disparity back into the camera view the same way.

The JAX package has three TPU kernels for this one contract -- the banded
walk (``remap_static``), the host-composed two-gather variant
(``method="composed"``) and the HBM-banded variant for sources too big for
VMEM (``remap_banded_hbm``) -- because a TPU gather is a serial scalar
loop and VMEM is small.  On the H100 the hardware gathers and the 1.2 MB
camera scan sits in L2, so every route here lands on ONE kernel,
``remap_gather`` (``csrc/remap.cu``).  The maps are static, so the host
packs ``(yi, xi, inb)`` once per calibration into one int32 flat index
(``pack_remap_index``: ``yi * Ws + xi``, -1 for a zero), and the kernel
reads 4 B a destination, four destinations a thread.  So the JAX
package's ``method`` and ``col_span`` arguments, which choose among its
kernels, have no counterpart here.  With no ``inb`` mask, ``xi == Ws``
marks an out-of-range destination (the JAX package's zero column).

On a CUDA tensor ``remap_gather`` launches the kernel; on a CPU tensor it
runs the plain version, ``remap_gather_plain``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from xmaps_tpu_torch.ops import _build

__all__ = [
    "build_remap_indices",
    "pack_remap_index",
    "remap_gather",
    "remap_gather_plain",
    "remap_static",
    "prepare_remap_static",
    "apply_remap_static",
    "upload",
    "banded_hbm_viable",
    "remap_banded_hbm",
]


def build_remap_indices(map_x: np.ndarray, map_y: np.ndarray, src_shape):
    """Host-precomputed integer index maps with remap_nearest semantics.

    Returns (yi, xi, inb): int32 index arrays of map shape plus the
    in-bounds mask.  Out-of-range destinations get a clamped row and the
    column Ws (the JAX package's padded zero column)."""
    Hs, Ws = src_shape
    xi = np.rint(np.asarray(map_x)).astype(np.int64)
    yi = np.rint(np.asarray(map_y)).astype(np.int64)
    inb = (xi >= 0) & (xi < Ws) & (yi >= 0) & (yi < Hs)
    yi = np.clip(yi, 0, Hs - 1).astype(np.int32)
    xi = np.where(inb, np.clip(xi, 0, Ws - 1), Ws).astype(np.int32)
    return yi, xi, inb


def pack_remap_index(yi, xi, inb, src_shape) -> np.ndarray:
    """(yi, xi, inb) index maps -> one contiguous int32 flat index into a
    source of ``src_shape``: ``yi * Ws + xi`` where the destination is
    valid, -1 where it is zero.  Valid means ``inb`` (when given) and
    ``(yi, xi)`` inside the source, so ``xi == Ws`` (the JAX package's zero
    column) is -1.  Raises where the source has 2**31 elements or more."""
    Hs, Ws = src_shape
    if Hs * Ws >= 2**31:
        raise ValueError(f"pack_remap_index: source {Hs}x{Ws} has >= 2**31 elements")
    yi = np.asarray(yi, np.int64)
    xi = np.asarray(xi, np.int64)
    if yi.shape != xi.shape:
        raise ValueError(f"pack_remap_index: yi {yi.shape} and xi {xi.shape} differ")
    ok = (yi >= 0) & (yi < Hs) & (xi >= 0) & (xi < Ws)
    if inb is not None:
        inb = np.asarray(inb, bool)
        if inb.shape != yi.shape:
            raise ValueError(f"pack_remap_index: inb {inb.shape} != {yi.shape}")
        ok &= inb
    return np.ascontiguousarray(np.where(ok, yi * Ws + xi, -1), np.int32)


def remap_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``remap_gather`` (any device): a gather
    through the flat index, 0 where it is -1 (or outside the source)."""
    n = src.numel()
    flat = torch.cat([src.reshape(-1), src.new_zeros(1)])
    i = idx.long()
    return flat[torch.where((i >= 0) & (i < n), i, n)]


def remap_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(Hs, Ws) float32 source + (H, W) int32 packed flat index
    (:func:`pack_remap_index`) -> (H, W) float32, ``src.flat[idx]`` with 0
    where ``idx`` is -1.

    Kernel B: it replaces the TPU kernels ``remap_static``
    (``xmaps_tpu/ops/pallas_remap.py:411``), ``_remap_static_composed_call``
    (``:235``) and ``remap_banded_hbm`` (``:542``), and the XLA flat gather
    of the ESL back-remap.  The kernel reads the index 16 bytes at a time,
    so ``idx`` must be 16-byte aligned (a ``ValueError`` otherwise).
    """
    dev = src.device
    if dev.type == "cpu":
        return remap_gather_plain(src, idx)
    if dev.type != "cuda":
        raise ValueError(f"remap_gather: unsupported device {dev}")
    for name, a, dtype in (("src", src, torch.float32), ("idx", idx, torch.int32)):
        if a.device != dev or a.dtype != dtype or not a.is_contiguous() or a.dim() != 2:
            raise ValueError(
                f"remap_gather: {name} must be a contiguous 2-D {dtype} tensor on {dev}, "
                f"got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    if idx.data_ptr() % 16:
        raise ValueError("remap_gather: idx must be 16-byte aligned (the kernel reads int4)")
    if src.numel() >= 2**31:
        raise ValueError(f"remap_gather: source {tuple(src.shape)} has >= 2**31 elements")
    out = torch.empty(tuple(idx.shape), dtype=torch.float32, device=dev)
    _build.launch(
        dev, "remap_gather", "remap_gather",
        src.data_ptr(), src.numel(), idx.data_ptr(), idx.numel(), out.data_ptr(),
    )
    return out


def upload(arrs, device) -> tuple:
    """The arrays of :func:`prepare_remap_static` as tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in arrs)


def remap_static(src, yi, xi, out_shape, inb=None):
    """src (Hs, Ws) float32 tensor + host int index maps -> (H, W) float32
    on src's device.

    ``inb``: the in-bounds mask from build_remap_indices; without it,
    ``xi == Ws`` marks out-of-range destinations."""
    cfg, arrs = prepare_remap_static(yi, xi, inb, out_shape, tuple(src.shape))
    return apply_remap_static(src, upload(arrs, src.device), cfg)


class RemapStaticCfg(NamedTuple):
    """Static half of a prepared remap (see :func:`prepare_remap_static`)."""

    out_shape: tuple


def prepare_remap_static(yi, xi, inb, out_shape, src_shape):
    """Host-side preparation of a static remap into a source of
    ``src_shape``: (cfg, (idx,)) with ``idx`` the packed int32 flat index of
    :func:`pack_remap_index`, of ``out_shape``.  Upload it once per
    calibration and call :func:`apply_remap_static` per source."""
    idx = pack_remap_index(yi, xi, inb, src_shape)
    if idx.shape != tuple(out_shape):
        raise ValueError(f"prepare_remap_static: index maps {idx.shape} != {tuple(out_shape)}")
    return RemapStaticCfg(tuple(out_shape)), (idx,)


def apply_remap_static(src: torch.Tensor, arrs, cfg: RemapStaticCfg) -> torch.Tensor:
    """Device half of :func:`prepare_remap_static`: ``arrs`` is its
    ``(idx,)`` as a tensor on src's device."""
    (idx,) = arrs
    assert tuple(idx.shape) == cfg.out_shape
    return remap_gather(src, idx)


def banded_hbm_viable(src_shape, yi, xi, inb, out_shape) -> bool:
    """Whether :func:`remap_banded_hbm` can run these maps: always, since
    kernel B has no VMEM band to fit (the JAX package's check is about a
    TPU scratch buffer)."""
    del src_shape, yi, xi, inb, out_shape
    return True


def remap_banded_hbm(src: torch.Tensor, yi, xi, inb, out_shape) -> torch.Tensor:
    """Large-source remap, ``where(inb, src[clip(yi), clip(xi)], 0)``, as
    the JAX package's ``remap_banded_hbm``: the host indices are clamped
    into the source first, then packed, then kernel B gathers."""
    Hs, Ws = src.shape
    yi = np.clip(np.asarray(yi, np.int64), 0, Hs - 1)
    xi = np.clip(np.asarray(xi, np.int64), 0, Ws - 1)
    cfg, arrs = prepare_remap_static(yi, xi, inb, out_shape, (Hs, Ws))
    return apply_remap_static(src, upload(arrs, src.device), cfg)
