"""Per-event rectification gathers + X-map disparity lookup.

Port of ``xmaps_tpu.ops.disparity`` (the reference's
cam_proj_calibration.py:277-281 + x_maps_disparity.py:9-32):

1. rectify: two 2D gathers through the inverse camera LUTs;
2. normalize event time to [0, 1] within the frame (masked min/max);
3. scale to an X-map time bin with round-half-to-even;
4. gather the projector column from the X-map;
5. disparity = x_proj - x_rect - X_OFFSET with inlier masking.

These are the plain PyTorch versions; on CUDA tensors the frame pipeline
runs steps 1, 4 and 5 (plus the scatter) as one kernel
(``ops.cuda_events``), fed with the time bins computed here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from xmaps_tpu_torch.config import X_OFFSET
from xmaps_tpu_torch.ops.event_batch import EventBatch

__all__ = [
    "rectify_events",
    "time_bounds",
    "scale_time",
    "compute_event_disparity",
    "DisparityResult",
]


class DisparityResult(NamedTuple):
    disp: torch.Tensor  # (N,) float32, 0 where not inlier
    x_rect: torch.Tensor  # (N,) int32 rectified x (i16 semantics)
    y_rect: torch.Tensor  # (N,) int32 rectified y (i16 semantics)
    inlier: torch.Tensor  # (N,) bool
    t_scaled: torch.Tensor  # (N,) int32 X-map time bin
    #: (N,) int32 raw clipped X-map value x_map[clip(yr), clip(t)], defined
    #: for every lane (not zeroed by the inlier mask)
    x_proj: torch.Tensor


def rectify_events(
    x: torch.Tensor,
    y: torch.Tensor,
    mapx_i16: torch.Tensor,
    mapy_i16: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-event rectification: 2 gathers through the inverse camera LUT
    (reference: cam_proj_calibration.py:277-281).  Indices are clamped so
    padding lanes stay in bounds."""
    H, W = mapx_i16.shape
    yc = y.clamp(0, H - 1).long()
    xc = x.clamp(0, W - 1).long()
    return mapx_i16[yc, xc].int(), mapy_i16[yc, xc].int()


def time_bounds(
    t: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked (min, max) of event times, with identity elements for
    invalid lanes: 0-dim for one frame's (N,) lanes, (F, 1) for a group's
    (F, N) (each frame's own, broadcasting against its row).
    ``masked_fill`` takes the identity as a kernel argument (``torch.where``
    with a Python scalar first fills a device tensor with it)."""
    big = float("inf") if t.is_floating_point() else torch.iinfo(t.dtype).max
    invalid = ~valid
    keep = t.dim() > 1
    return (t.masked_fill(invalid, big).amin(-1, keepdim=keep),
            t.masked_fill(invalid, -big).amax(-1, keepdim=keep))


def _scale_time_int(
    t: torch.Tensor, t_min: torch.Tensor, t_max: torch.Tensor, t_px_scale: int
) -> torch.Tensor:
    """Exact integer round-half-to-even of (t - min) * scale / (max - min).

    Floor division, as JAX's ``//``: padding lanes (t = 0 below t_min)
    give negative numerators.  Assumes (max-min) * scale * 2 < 2^31.
    """
    rng = torch.clamp_min(t_max - t_min, 1)
    num = (t - t_min) * t_px_scale
    q = torch.div(num, rng, rounding_mode="floor")
    r = num - q * rng
    twice = 2 * r
    round_up = (twice > rng) | ((twice == rng) & (q % 2 == 1))
    return (q + round_up.int()).int()


def _scale_time_float(
    t: torch.Tensor, t_min: torch.Tensor, t_max: torch.Tensor, t_px_scale: int
) -> torch.Tensor:
    """Float path for normalized [0, 1] timestamps (offline eval).
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    rng = torch.clamp_min(t_max - t_min, 1e-30)
    norm = (t - t_min) / rng
    scale = torch.tensor(float(t_px_scale), dtype=torch.float32, device=t.device)
    return torch.round(norm * scale).int()


def scale_time(
    t: torch.Tensor,
    valid: torch.Tensor,
    t_px_scale: int,
    bounds: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """X-map time bin of every lane: exact integer arithmetic for integer
    timestamps, float math for normalized float ones.  ``t`` and ``valid``
    are one frame's (N,) lanes or a group's (F, N), each row binned within
    its own frame's bounds.

    ``bounds``: the frame's (min, max), as ``time_bounds`` gives them
    (0-dim for one frame, (F, 1) for a group), where ``t`` holds only part
    of the frame's lanes: an event shard bins with the min and max over
    all its frame's shards (``parallel.sharding``, JAX's ``pmin`` /
    ``pmax``).  None: the bounds of ``t`` itself."""
    t_min, t_max = time_bounds(t, valid) if bounds is None else bounds
    if t.is_floating_point():
        return _scale_time_float(t, t_min, t_max, t_px_scale)
    return _scale_time_int(t, t_min, t_max, t_px_scale)


def compute_event_disparity(
    batch: EventBatch,
    mapx_i16: torch.Tensor,
    mapy_i16: torch.Tensor,
    x_map: torch.Tensor,
    *,
    t_px_scale: int,
    t_scaled: Optional[torch.Tensor] = None,
) -> DisparityResult:
    """Full per-event disparity stage (reference: x_maps_disparity.py:9-32).

    The inlier mask combines batch validity, rectified-y in
    [0, H_xmap - 2] (reference :23), disparity >= 0 (reference :29, which
    also rejects undefined X-map entries) and the time bin in the X-map.
    """
    xr, yr = rectify_events(batch.x, batch.y, mapx_i16, mapy_i16)
    if t_scaled is None:
        t_scaled = scale_time(batch.t, batch.valid, t_px_scale)

    H_xmap, W_time = x_map.shape
    y_in = (yr >= 0) & (yr < H_xmap - 1) & batch.valid
    yg = yr.clamp(0, H_xmap - 1).long()
    tg = t_scaled.clamp(0, W_time - 1).long()
    x_proj = x_map[yg, tg].int()

    disp = x_proj - xr - X_OFFSET
    inlier = y_in & (disp >= 0) & (t_scaled >= 0) & (t_scaled < W_time)
    disp_f32 = torch.where(inlier, disp, 0).float()
    return DisparityResult(
        disp=disp_f32, x_rect=xr, y_rect=yr, inlier=inlier,
        t_scaled=t_scaled, x_proj=x_proj,
    )
