"""The bytes a call of the group path must move, and the peaks they are
held against.

Each input is read once and each output written once, whatever kernels do
the work (so fusing or splitting kernels leaves the count as it is); a
gathered table counts the distinct entries the call's events touch.  For a
group of F frames:

- group path: the staged event words (4 B an event), the distinct camera-LUT
  entries (4 B: the packed rectified x and y of an event's pixel) and X-map
  entries (2 B: one a distinct rectified row and time bin an event looks
  up), in the projector view the two int16 projector maps once (4 B a
  projector pixel), the colour-table entries shown (4 B a distinct
  disparity on the displayed planes), and each frame's packed image (4 B a
  pixel) and inlier count (4 B) written;
- projector tail: each frame's disparity crop read (4 B a pixel of the
  rectified window the projector maps sample, with the 3-pixel halo of the
  dilation), the projector maps once, the colour-table entries shown, each
  frame's packed image written.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark.reference import frame as ref_frame

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def hbm_bytes_per_s(card: str):
    """The card's published memory bandwidth, or None for a card the table
    lacks."""
    with open(PEAKS) as f:
        return json.load(f).get(card, {}).get("hbm_bytes_per_s")


def _lookups(tab, frames, cap):
    """(distinct LUT pixels, distinct X-map entries, staged events, the
    displayed planes) of a group's frames."""
    pix, xm, staged = set(), set(), 0
    for ev in frames:
        ev = ev[:cap]
        staged += len(ev)
        x, y, t = (torch.from_numpy(ev[k].astype(np.int64)).to(tab.device) for k in ("x", "y", "t"))
        pix.update((y * 65536 + x).unique().tolist())
        h, bins = tab.x_map.shape
        yr = tab.cam_mapy[y, x]
        tb = ref_frame.time_bins(t, bins - 1)
        ok = (yr >= 0) & (yr < h - 1)
        xm.update((yr[ok] * bins + tb[ok]).unique().tolist())
    return len(pix), len(xm), staged


def crop_pixels(tab) -> int:
    """Pixels of the rectified window the projector maps sample, with the
    dilation's halo, clipped to the rectified frame."""
    h, w = tab.rect
    px, py = tab.proj_mapx, tab.proj_mapy
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    if not bool(inb.any()):
        return h * w
    r0, r1 = max(int(py[inb].min()) - 3, 0), min(int(py[inb].max()) + 3, h - 1)
    c0, c1 = max(int(px[inb].min()) - 3, 0), min(int(px[inb].max()) + 3, w - 1)
    return (r1 - r0 + 1) * (c1 - c0 + 1)


def shown(tab, frames, cap, camera_view) -> int:
    """Distinct disparities on a group's displayed planes."""
    vals = set()
    for ev in frames:
        ev = ev[:cap]
        xyz = [torch.from_numpy(ev[k].astype(np.int64)).to(tab.device) for k in ("x", "y", "t")]
        p, _ = ref_frame.plane(tab, *xyz, camera_view=camera_view)
        vals.update(p.unique().tolist())
    return len(vals)


def bytes_of(*, staged, lut, xmap, distinct, frames, out_px, proj_px, crop_px) -> dict:
    """The formulas of the module docstring from the counts of one group
    (``proj_px`` 0 in the camera view, which has no tail)."""
    maps = 4 * proj_px
    out = {"group_path": 4 * staged + 4 * lut + 2 * xmap + maps + 4 * distinct
           + frames * (4 * out_px + 4)}
    if proj_px:
        out["tail"] = frames * 4 * crop_px + maps + 4 * distinct + frames * 4 * out_px
    return out


def group_bytes(tab, frames, cap, camera_view) -> dict:
    """``bytes_of`` one group's frames, counted with the reference's tables."""
    n_pix, n_xm, staged = _lookups(tab, frames, cap)
    proj_px = 0 if camera_view else tab.proj_mapx.numel()
    return bytes_of(staged=staged, lut=n_pix, xmap=n_xm,
                    distinct=shown(tab, frames, cap, camera_view), frames=len(frames),
                    out_px=tab.camera[0] * tab.camera[1] if camera_view else proj_px,
                    proj_px=proj_px, crop_px=0 if camera_view else crop_pixels(tab))
