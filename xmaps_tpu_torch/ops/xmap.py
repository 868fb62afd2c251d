"""X-map construction: time map (y, x -> t) to X-map (y, t -> x).

Port of ``xmaps_tpu.ops.xmap.build_x_map`` (the reference's x_map.py:5-55).
For each rectified row y and each time bin t, find the x whose time-map
entry is nearest to t (first x on ties), rejecting matches farther than two
scanline periods and marking undefined entries with 0 (defined entries are
offset by X_OFFSET).  The argmin runs in float32 over blocks of rows, like
the JAX build, and matches it bit for bit.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from xmaps_tpu_torch.config import X_OFFSET

__all__ = ["build_x_map", "xmap_cache_key"]


def xmap_cache_key(
    time_map: np.ndarray, x_map_width: int, t_px_scale: int, num_scanlines: int
) -> str:
    """Disk-cache key of an X-map: the JAX engine's key, so the two share
    cached ``xmap_<key>.npy`` files."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(time_map).tobytes())
    h.update(f"{x_map_width}|{t_px_scale}|{num_scanlines}".encode())
    return h.hexdigest()[:24]


def build_x_map(
    time_map: torch.Tensor,
    *,
    x_map_width: int,
    t_px_scale: int,
    num_scanlines: int,
    row_block: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Build the X-map on ``time_map``'s device.

    Args:
        time_map: (H_rect, W_rect) float32 rectified projector time map.
        x_map_width: number of time bins (reference: projector width).
        t_px_scale: time scale (x_map_width - 1).
        num_scanlines: scanline count for the rejection threshold.
        row_block: rows per step (peak memory row_block * x_map_width *
            W_rect floats).

    Returns:
        (x_map, t_diffs): (H_rect, x_map_width) int16 X-map and float32
        min time differences.
    """
    dev = time_map.device
    # the time bins as the compiled JAX build computes them: XLA turns the
    # division by the constant scale into a multiplication by its f32
    # reciprocal (1 ulp off the IEEE quotient in some bins); made on the
    # host so every device gets the same bins
    inv_scale = np.float32(1.0) / np.float32(t_px_scale)
    t_vals_np = np.arange(x_map_width, dtype=np.float32) * inv_scale
    t_vals = torch.from_numpy(t_vals_np).to(dev)
    max_t_diff = float(np.float32(2.0 / num_scanlines))

    tm = torch.where(time_map == 0.0, float("inf"), time_map.float())
    H = tm.shape[0]
    x_map = torch.empty((H, x_map_width), dtype=torch.int16, device=dev)
    t_diffs = torch.empty((H, x_map_width), dtype=torch.float32, device=dev)
    t_nonzero = (t_vals != 0.0)[None, :]
    for r0 in range(0, H, row_block):
        rows = tm[r0 : r0 + row_block]  # (B, W)
        diffs = (t_vals[None, :, None] - rows[:, None, :]).abs()  # (B, T, W)
        best_x = diffs.argmin(dim=-1)
        best_d = diffs.amin(dim=-1)
        ok = torch.isfinite(best_d) & (best_d <= max_t_diff) & t_nonzero
        x_map[r0 : r0 + row_block] = torch.where(ok, best_x + X_OFFSET, 0).to(
            torch.int16
        )
        t_diffs[r0 : r0 + row_block] = torch.where(ok, best_d, 0.0)
    return x_map, t_diffs
