"""The plain reference of one frame: events -> colorized depth map.

Plain PyTorch on any device (the benchmark runs it on the card once the
window has closed, the tests on the CPU), written from X-maps' published
per-frame math (``x_maps_disparity.py``, ``cam_proj_calibration.py``,
``disp_to_depth.py``, ``x_map.py``) and sharing no code with the system
under test.  Per frame:

1. rectify: each event's rectified (x, y) from the camera LUT;
2. time bin: ``(t - min) * scale / (max - min)`` rounded half to even,
   exactly (integer arithmetic; float64 gives the same except at exact
   ties), ``scale`` = projector width - 1;
3. X-map lookup of the projector column, disparity = x_proj - x_rect -
   4242; an inlier has a rectified y in [0, H - 2], a defined X-map entry
   and a disparity >= 0;
4. scatter: the disparity map, the last event in stream order winning a
   pixel (NumPy fancy assignment's rule), at (y_rect, x_proj - 4242) in
   the rectified frame (projector view) or at the raw pixel (camera view);
5. projector view only: 7 x 7 max dilation, nearest remap to the
   projector through its LUT (0 outside the rectified frame);
6. depth = max(p03 / disp, 1e-9) in float32, clipped to [z_near, z_far],
   scaled to 0..255 and truncated, TURBO colour, undefined pixels white;
   returned as one packed word a pixel (B | G << 8 | R << 16).

The X-map (``x_map.py``): for each rectified row and each of the
projector-width time bins ``b * float32(1 / scale)``, the first x whose
rectified scan time is nearest in float32, undefined (0) where bin 0,
where no time is within 2 / projector width, or where the row has no
time; defined entries hold x + 4242.

``lower=True`` computes the same one precision step down (the time bins
from a float32 quotient, the depth and its colour in bfloat16): the
control that the comparison has to fail.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

X_OFFSET = 4242

#: cv2.COLORMAP_TURBO, one packed word (B | G << 8 | R << 16) an entry
TURBO_PACKED = np.array([
    0x30123B, 0x321543, 0x33184A, 0x341B51, 0x351E58, 0x36215F, 0x372466, 0x38276D,
    0x392A73, 0x3A2D79, 0x3B2F80, 0x3C3286, 0x3D358B, 0x3E3891, 0x3F3B97, 0x3F3E9C,
    0x4040A2, 0x4143A7, 0x4146AC, 0x4249B1, 0x424BB5, 0x434EBA, 0x4451BF, 0x4454C3,
    0x4456C7, 0x4559CB, 0x455CCF, 0x455ED3, 0x4661D6, 0x4664DA, 0x4666DD, 0x4669E0,
    0x466BE3, 0x476EE6, 0x4771E9, 0x4773EB, 0x4776EE, 0x4778F0, 0x477BF2, 0x467DF4,
    0x4680F6, 0x4682F8, 0x4685FA, 0x4687FB, 0x458AFC, 0x458CFD, 0x448FFE, 0x4391FE,
    0x4294FF, 0x4196FF, 0x4099FF, 0x3E9BFE, 0x3D9EFE, 0x3BA0FD, 0x3AA3FC, 0x38A5FB,
    0x37A8FA, 0x35ABF8, 0x33ADF7, 0x31AFF5, 0x2FB2F4, 0x2EB4F2, 0x2CB7F0, 0x2AB9EE,
    0x28BCEB, 0x27BEE9, 0x25C0E7, 0x23C3E4, 0x22C5E2, 0x20C7DF, 0x1FC9DD, 0x1ECBDA,
    0x1CCDD8, 0x1BD0D5, 0x1AD2D2, 0x1AD4D0, 0x19D5CD, 0x18D7CA, 0x18D9C8, 0x18DBC5,
    0x18DDC2, 0x18DEC0, 0x18E0BD, 0x19E2BB, 0x19E3B9, 0x1AE4B6, 0x1CE6B4, 0x1DE7B2,
    0x1FE9AF, 0x20EAAC, 0x22EBAA, 0x25ECA7, 0x27EEA4, 0x2AEFA1, 0x2CF09E, 0x2FF19B,
    0x32F298, 0x35F394, 0x38F491, 0x3CF58E, 0x3FF68A, 0x43F787, 0x46F884, 0x4AF880,
    0x4EF97D, 0x52FA7A, 0x55FA76, 0x59FB73, 0x5DFC6F, 0x61FC6C, 0x65FD69, 0x69FD66,
    0x6DFE62, 0x71FE5F, 0x75FE5C, 0x79FE59, 0x7DFF56, 0x80FF53, 0x84FF51, 0x88FF4E,
    0x8BFF4B, 0x8FFF49, 0x92FF47, 0x96FE44, 0x99FE42, 0x9CFE40, 0x9FFD3F, 0xA1FD3D,
    0xA4FC3C, 0xA7FC3A, 0xA9FB39, 0xACFB38, 0xAFFA37, 0xB1F936, 0xB4F836, 0xB7F735,
    0xB9F635, 0xBCF534, 0xBEF434, 0xC1F334, 0xC3F134, 0xC6F034, 0xC8EF34, 0xCBED34,
    0xCDEC34, 0xD0EA34, 0xD2E935, 0xD4E735, 0xD7E535, 0xD9E436, 0xDBE236, 0xDDE037,
    0xDFDF37, 0xE1DD37, 0xE3DB38, 0xE5D938, 0xE7D739, 0xE9D539, 0xEBD339, 0xECD13A,
    0xEECF3A, 0xEFCD3A, 0xF1CB3A, 0xF2C93A, 0xF4C73A, 0xF5C53A, 0xF6C33A, 0xF7C13A,
    0xF8BE39, 0xF9BC39, 0xFABA39, 0xFBB838, 0xFBB637, 0xFCB336, 0xFCB136, 0xFDAE35,
    0xFDAC34, 0xFEA933, 0xFEA732, 0xFEA431, 0xFEA130, 0xFE9E2F, 0xFE9B2D, 0xFE992C,
    0xFE962B, 0xFE932A, 0xFE9029, 0xFD8D27, 0xFD8A26, 0xFC8725, 0xFC8423, 0xFB8122,
    0xFB7E21, 0xFA7B1F, 0xF9781E, 0xF9751D, 0xF8721C, 0xF76F1A, 0xF66C19, 0xF56918,
    0xF46617, 0xF36315, 0xF26014, 0xF15D13, 0xF05B12, 0xEF5811, 0xED5510, 0xEC530F,
    0xEB500E, 0xEA4E0D, 0xE84B0C, 0xE7490C, 0xE5470B, 0xE4450A, 0xE2430A, 0xE14109,
    0xDF3F08, 0xDD3D08, 0xDC3B07, 0xDA3907, 0xD83706, 0xD63506, 0xD43305, 0xD23105,
    0xD02F05, 0xCE2D04, 0xCC2B04, 0xCA2A04, 0xC82803, 0xC52603, 0xC32503, 0xC12302,
    0xBE2102, 0xBC2002, 0xB91E02, 0xB71D02, 0xB41B01, 0xB21A01, 0xAF1801, 0xAC1701,
    0xA91601, 0xA71401, 0xA41301, 0xA11201, 0x9E1001, 0x9B0F01, 0x980E01, 0x950D01,
    0x920B01, 0x8E0A01, 0x8B0902, 0x880802, 0x850702, 0x810602, 0x7E0502, 0x7A0403,
], dtype=np.int32)
WHITE = 0xFFFFFF


def build_x_map(time_map: torch.Tensor, bins: int, block: int = 32) -> torch.Tensor:
    """(H, bins) int32 X-map of a rectified time map (H, W) float32."""
    scale = bins - 1
    t_vals = torch.from_numpy(np.arange(bins, dtype=np.float32)
                              * (np.float32(1.0) / np.float32(scale))).to(time_map.device)
    limit = float(np.float32(2.0 / bins))
    tm = torch.where(time_map == 0, float("inf"), time_map)
    out = torch.empty((tm.shape[0], bins), dtype=torch.int32, device=tm.device)
    for r in range(0, tm.shape[0], block):
        d = (t_vals[None, :, None] - tm[r:r + block, None, :]).abs()
        arg = d.argmin(dim=-1)  # the first x of the least difference
        best = d.gather(-1, arg[..., None])[..., 0]
        ok = torch.isfinite(best) & (best <= limit) & (t_vals != 0)[None, :]
        out[r:r + block] = torch.where(ok, arg.int() + X_OFFSET, 0)
    return out


class Tables:
    """The reference's tables of one rig, on ``device``."""

    def __init__(self, tabs: dict, rig: dict, device):
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.device = torch.device(device)
        self.cam_mapx = dev(tabs["cam_mapx"]).long()
        self.cam_mapy = dev(tabs["cam_mapy"]).long()
        self.proj_mapx = dev(tabs["proj_mapx"]).long()
        self.proj_mapy = dev(tabs["proj_mapy"]).long()
        self.x_map = build_x_map(dev(tabs["time_map"]), rig["projector_width"]).long()
        self.p03 = float(np.float32(tabs["p03"]))
        self.rect = (rig["rect_height"], rig["rect_width"])
        self.camera = (rig["camera_height"], rig["camera_width"])
        self.turbo = dev(TURBO_PACKED)


def time_bins(t: torch.Tensor, scale: int, lower: bool = False) -> torch.Tensor:
    """Each event's X-map time bin within its frame (step 2)."""
    t0 = t.min()
    rng = torch.clamp_min(t.max() - t0, 1)
    if lower:
        return torch.round((t - t0).float() / rng.float() * scale).long()
    num = (t - t0) * scale
    q = torch.div(num, rng, rounding_mode="floor")
    twice = 2 * (num - q * rng)
    return q + ((twice > rng) | ((twice == rng) & (q % 2 == 1))).long()


def disparities(tab: Tables, x, y, t, lower: bool = False):
    """Steps 1-3: (disparity int64, inlier mask, y_rect, x_proj)."""
    xr, yr = tab.cam_mapx[y, x], tab.cam_mapy[y, x]
    h, bins = tab.x_map.shape
    tb = time_bins(t, bins - 1, lower)
    x_proj = tab.x_map[yr.clamp(0, h - 1), tb.clamp(0, bins - 1)]
    disp = x_proj - xr - X_OFFSET
    inl = (yr >= 0) & (yr < h - 1) & (disp >= 0) & (tb >= 0) & (tb < bins)
    return disp, inl, yr, x_proj


def scatter_last(h: int, w: int, ys, xs, vals, keep) -> torch.Tensor:
    """(h, w) float32 map of ``vals`` at (ys, xs) where ``keep``, the last
    lane winning a pixel; 0 elsewhere."""
    idx = torch.arange(len(vals), device=vals.device)
    lin = (ys * w + xs)[keep]
    win = torch.full((h * w,), -1, dtype=torch.long, device=vals.device)
    win.scatter_reduce_(0, lin, idx[keep], reduce="amax")
    out = torch.where(win >= 0, vals[win.clamp_min(0)].float(), 0.0)
    return out.view(h, w)


def colorize(tab: Tables, disp: torch.Tensor, z_near: float, z_far: float,
             lower: bool = False) -> torch.Tensor:
    """Step 6 on a disparity plane: packed BGR words."""
    dt = torch.bfloat16 if lower else torch.float32

    def scalar(v):
        return torch.tensor(float(np.float32(v)), dtype=torch.float32, device=disp.device).to(dt)

    d = disp.to(dt)
    p03, zn, zf = scalar(tab.p03), scalar(z_near), scalar(z_far)
    depth = torch.where(d != 0, torch.clamp_min(p03 / torch.where(d != 0, d, 1), 1e-9), 0)
    val = (torch.minimum(torch.maximum(depth, zn), zf) - zn) / (zf - zn) * 255.0
    u8 = torch.where(depth != 0, val, 0).clamp(0, 255).float().to(torch.uint8).long()
    return torch.where(u8 == 0, WHITE, tab.turbo[u8]).int()


def plane(tab: Tables, x, y, t, *, camera_view: bool, lower: bool = False):
    """Steps 1-5: one frame's displayed disparity plane (float32) and its
    inlier count; ``x``, ``y``, ``t`` are int64 tensors of its events in
    stream order, on the tables' device."""
    disp, inl, yr, x_proj = disparities(tab, x, y, t, lower)
    if camera_view:
        h, w = tab.camera
        return scatter_last(h, w, y, x, disp, inl), int(inl.sum())
    h, w = tab.rect
    rect = scatter_last(h, w, yr.clamp(0, h - 1), (x_proj - X_OFFSET).clamp(0, w - 1), disp, inl)
    dil = F.max_pool2d(rect[None, None], 7, stride=1, padding=3)[0, 0]
    px, py = tab.proj_mapx, tab.proj_mapy
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    return torch.where(inb, dil[py.clamp(0, h - 1), px.clamp(0, w - 1)], 0.0), int(inl.sum())


def frame(tab: Tables, x, y, t, *, camera_view: bool, z_near: float, z_far: float,
          lower: bool = False):
    """One frame's (packed BGR (H, W) int32, inlier count)."""
    disp, n = plane(tab, x, y, t, camera_view=camera_view, lower=lower)
    return colorize(tab, disp, z_near, z_far, lower), n
