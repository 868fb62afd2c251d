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
``remap_gather`` (``csrc/remap.cu``): one thread per destination pixel.
The ``method`` and ``col_span`` arguments are accepted so that callers keep
their signatures; they select nothing.  With no ``inb`` mask, ``xi == Ws``
marks an out-of-range destination (the JAX package's zero column).

On a CUDA tensor ``remap_gather`` launches the kernel; on a CPU tensor it
runs the plain version, ``remap_gather_plain``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from xmaps_tpu_torch.ops import _build
from xmaps_tpu_torch.ops.image_tail import remap_nearest_i16

__all__ = [
    "build_remap_indices",
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


def remap_gather_plain(
    src: torch.Tensor,
    yi: torch.Tensor,
    xi: torch.Tensor,
    inb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``remap_gather`` (any device)."""
    out = remap_nearest_i16(src, xi, yi)
    return out if inb is None else torch.where(inb, out, 0.0)


def remap_gather(
    src: torch.Tensor,
    yi: torch.Tensor,
    xi: torch.Tensor,
    inb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(Hs, Ws) float32 source + (H, W) int32 index maps -> (H, W) float32,
    ``where(inb & in range, src[yi, xi], 0)``; ``inb`` (bool) is optional.

    Kernel B: it replaces the TPU kernels ``remap_static``
    (``xmaps_tpu/ops/pallas_remap.py:411``), ``_remap_static_composed_call``
    (``:235``) and ``remap_banded_hbm`` (``:542``), and the XLA flat gather
    of the ESL back-remap.
    """
    dev = src.device
    if dev.type == "cpu":
        return remap_gather_plain(src, yi, xi, inb)
    if dev.type != "cuda":
        raise ValueError(f"remap_gather: unsupported device {dev}")
    shape = tuple(yi.shape)
    checks = [("src", src, torch.float32, tuple(src.shape)),
              ("yi", yi, torch.int32, shape), ("xi", xi, torch.int32, shape)]
    if inb is not None:
        checks.append(("inb", inb, torch.bool, shape))
    for name, a, dtype, want in checks:
        if (a.device != dev or a.dtype != dtype or tuple(a.shape) != want
                or not a.is_contiguous() or a.dim() != 2):
            raise ValueError(
                f"remap_gather: {name} must be a contiguous 2-D {dtype} tensor of "
                f"shape {want} on {dev}, got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    lib = _build.load()
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    Hs, Ws = src.shape
    err = lib.remap_gather(
        src.data_ptr(), Hs, Ws, yi.data_ptr(), xi.data_ptr(),
        None if inb is None else inb.data_ptr(), yi.numel(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check("remap_gather", err)
    _build.LAUNCHES["remap_gather"] += 1
    return out


def upload(arrs, device) -> tuple:
    """The arrays of :func:`prepare_remap_static` as tensors on ``device``
    (None stays None)."""
    return tuple(None if a is None else torch.from_numpy(a).to(device) for a in arrs)


def remap_static(src, yi, xi, out_shape, col_span: Optional[int] = None,
                 inb=None, method: str = "auto"):
    """src (Hs, Ws) float32 tensor + host int index maps -> (H, W) float32
    on src's device.

    ``inb``: the in-bounds mask from build_remap_indices; without it,
    ``xi == Ws`` marks out-of-range destinations.  ``col_span`` and
    ``method`` ("auto", "walk", "composed") select TPU gather schedules in
    the JAX package and nothing here: every route is kernel B."""
    if method not in ("auto", "walk", "composed"):
        raise ValueError(f"unknown remap method {method!r}")
    cfg, arrs = prepare_remap_static(yi, xi, inb, out_shape, src.shape[1],
                                     col_span=col_span, method=method)
    return apply_remap_static(src, upload(arrs, src.device), cfg)


class RemapStaticCfg(NamedTuple):
    """Static half of a prepared remap (see :func:`prepare_remap_static`)."""

    out_shape: tuple


def prepare_remap_static(yi, xi, inb, out_shape, src_width,
                         col_span: Optional[int] = None, method: str = "auto"):
    """Host-side preparation of a static remap: (cfg, (yi, xi, inb)) as
    contiguous int32/int32/bool arrays of ``out_shape`` (``inb`` None when
    not given).  Upload the arrays once and call :func:`apply_remap_static`
    per source.  ``src_width``, ``col_span`` and ``method`` are accepted for
    the JAX package's signature; kernel B needs none of them."""
    del src_width, col_span, method
    H, W = out_shape
    yi = np.ascontiguousarray(np.asarray(yi), np.int32)
    xi = np.ascontiguousarray(np.asarray(xi), np.int32)
    assert yi.shape == xi.shape == (H, W), (yi.shape, xi.shape, out_shape)
    if inb is not None:
        inb = np.ascontiguousarray(np.asarray(inb), bool)
        assert inb.shape == (H, W)
    return RemapStaticCfg(tuple(out_shape)), (yi, xi, inb)


def apply_remap_static(src: torch.Tensor, arrs, cfg: RemapStaticCfg) -> torch.Tensor:
    """Device half of :func:`prepare_remap_static`: ``arrs`` are its
    arrays as tensors on src's device."""
    yi, xi, inb = arrs
    assert tuple(yi.shape) == cfg.out_shape
    return remap_gather(src, yi, xi, inb)


def banded_hbm_viable(src_shape, yi, xi, inb, out_shape) -> bool:
    """Whether :func:`remap_banded_hbm` can run these maps: always, since
    kernel B has no VMEM band to fit (the JAX package's check is about a
    TPU scratch buffer)."""
    del src_shape, yi, xi, inb, out_shape
    return True


def remap_banded_hbm(src: torch.Tensor, yi, xi, inb, out_shape) -> torch.Tensor:
    """Large-source remap, ``where(inb, src[clip(yi), clip(xi)], 0)``, as
    the JAX package's ``remap_banded_hbm``: the host indices are clamped
    into the source first, then kernel B gathers."""
    Hs, Ws = src.shape
    yi = np.clip(np.asarray(yi, np.int64), 0, Hs - 1)
    xi = np.clip(np.asarray(xi, np.int64), 0, Ws - 1)
    cfg, arrs = prepare_remap_static(yi, xi, inb, out_shape, Ws)
    return apply_remap_static(src, upload(arrs, src.device), cfg)
