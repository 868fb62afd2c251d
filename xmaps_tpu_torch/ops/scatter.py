"""Deterministic disparity-map scatter (plain PyTorch version).

Port of ``xmaps_tpu.ops.scatter`` for ``method="max"``.  The reference
scatters per-event disparities with NumPy fancy indexing, whose semantics
are "last write in index order wins" (cam_proj_calibration.py:299-317).
Each event's integer disparity is packed with its priority as

    packed = (priority + 1) * PACK + disp        (uint32)

and scattered with max: the highest priority wins, exactly NumPy's
last-write-wins, and ``packed % PACK`` recovers the disparity.  As in the
JAX package the key is unsigned 32-bit, so ``(capacity + 1) * PACK <
2**32``: capacities up to 524286 events, enough for the offline eval's
whole-image batch (640 x 480 = 307200).  torch has no full uint32
arithmetic, so the map is an int32 tensor holding the uint32 bit pattern:
keys of 2**31 and above read as negative int32, and ``unpack_disp`` (low
13 bits) is unaffected.  The plain version takes the max over int64 keys
and keeps their low 32 bits; the CUDA kernel (``ops.cuda_events``) does an
unsigned ``atomicMax`` on the same words.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["PACK", "MAX_CAPACITY", "scatter_disp_packed", "unpack_disp"]

#: Disparity field width.  Must exceed any valid disparity (bounded by the
#: rectified image width, <= ~5800 for the ESL configuration).
PACK = 8192

#: The largest event capacity (priorities < capacity) the uint32 key holds:
#: (capacity + 1) * PACK < 2**32.
MAX_CAPACITY = 2**32 // PACK - 2


def scatter_disp_packed(
    ys: torch.Tensor,
    xs: torch.Tensor,
    disp: torch.Tensor,
    inlier: torch.Tensor,
    *,
    height: int,
    width: int,
    index_offset: int = 0,
    priority: Optional[torch.Tensor] = None,
    pad_shape: Optional[tuple[int, int]] = None,
    window: Optional[tuple[int, int, int, int]] = None,
) -> torch.Tensor:
    """Scatter index-packed disparities; returns the packed map (int32
    tensor holding uint32 words, see the module docstring).

    The last-write-wins priority is the event index by default, shifted by
    ``index_offset``; ``priority`` overrides it with another
    order-equivalent permutation (all priorities < capacity).
    ``window=(oy, ox, wh, ww)`` scatters into a crop of the logical
    (height, width) frame and drops targets outside it; ``pad_shape``
    scatters into a larger zero-padded map.
    """
    n = ys.shape[0]
    if window is not None:
        oy, ox, wh, ww = window
        assert 0 <= oy and oy + wh <= height and 0 <= ox and ox + ww <= width
    else:
        oy = ox = 0
        wh, ww = height, width
    out_h, out_w = pad_shape if pad_shape is not None else (wh, ww)
    assert out_h >= wh and out_w >= ww
    assert (n + index_offset + 1) * PACK < 2**32, (
        f"event capacity {n} overflows the uint32 PACK packing"
    )
    disp_i = disp.int()
    ysc = ys - oy
    xsc = xs - ox
    ok = (
        inlier
        & (ysc >= 0)
        & (ysc < wh)
        & (xsc >= 0)
        & (xsc < ww)
        & (disp_i >= 0)
        & (disp_i < PACK)
    )
    if priority is None:
        priority = (
            torch.arange(n, dtype=torch.int32, device=ys.device) + index_offset
        )
    # int64 keys: the max over them is the unsigned 32-bit max
    packed = torch.where(ok, (priority.long() + 1) * PACK + disp_i, 0)
    # masked lanes go to one extra slot past the map, dropped below
    lin = torch.where(ok, ysc * out_w + xsc, out_h * out_w).long()
    flat = torch.zeros(out_h * out_w + 1, dtype=torch.int64, device=ys.device)
    flat.scatter_reduce_(0, lin, packed, reduce="amax")
    flat = flat[: out_h * out_w]
    # keep the low 32 bits as the int32 bit pattern
    return torch.where(flat >= 2**31, flat - 2**32, flat).int().view(out_h, out_w)


def unpack_disp(packed: torch.Tensor, pack: int = PACK) -> torch.Tensor:
    """Recover the float32 disparity map from a packed map (the low bits
    of the uint32 word; the int32 view's sign does not reach them)."""
    return (packed % pack).float()
