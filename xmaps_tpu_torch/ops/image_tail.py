"""Dense per-frame image tail: dilate -> remap -> depth -> colorize.

Port of ``xmaps_tpu.ops.image_tail`` (the reference's disp_to_depth.py):

- 7x7 max dilation of the sparse projector-view disparity map with -inf
  padding (cv2.dilate, disp_to_depth.py:74,86);
- nearest remap through the int16 inverse LUT, BORDER_CONSTANT(0)
  (disp_to_depth.py:89-96);
- depth = P[0,3] / disp with zero-preserve (disp_to_depth.py:46-63);
- clip/normalize to uint8 with C-style truncation (disp_to_depth.py:7-21);
- TURBO colormap + white where undefined (disp_to_depth.py:24-43).

These are the plain versions of the CUDA tail kernels (``ops.cuda_tail``).
Every division divides by a tensor on the operand's device, never by a
Python scalar: PyTorch's CUDA division by a CPU scalar multiplies by its
reciprocal, which is not the IEEE quotient the kernels and JAX compute.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from xmaps_tpu_torch.utils.colormap import TURBO_BGR_U8

__all__ = [
    "dilate_max",
    "remap_nearest_i16",
    "disparity_to_depth",
    "clip_normalize_u8",
    "colorize_turbo",
    "colorize_turbo_packed",
    "turbo_packed_lut",
]


def dilate_max(img: torch.Tensor, ksize: int = 7) -> torch.Tensor:
    """Grayscale max-dilation with a ksize x ksize square (odd ksize),
    SAME size; max_pool2d pads with -inf, as the JAX reduce_window."""
    return F.max_pool2d(
        img[None, None], ksize, stride=1, padding=ksize // 2
    )[0, 0]


def remap_nearest_i16(
    img: torch.Tensor, mapx: torch.Tensor, mapy: torch.Tensor
) -> torch.Tensor:
    """``out[i, j] = img[mapy[i, j], mapx[i, j]]`` where in bounds, else 0
    (BORDER_CONSTANT(0))."""
    H, W = img.shape
    xi = mapx.int()
    yi = mapy.int()
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    vals = img[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
    return torch.where(inb, vals, torch.zeros((), dtype=img.dtype, device=img.device))


def disparity_to_depth(disp_map: torch.Tensor, p03: torch.Tensor) -> torch.Tensor:
    """depth = max(P[0,3] / disp, 1e-9), zero where disp == 0 (the
    reference's simplified rectified-depth formula)."""
    safe = torch.where(disp_map == 0.0, 1.0, disp_map)
    depth = torch.clamp_min(p03 / safe, 1e-9)
    return torch.where(disp_map == 0.0, 0.0, depth).float()


def clip_normalize_u8(
    depth: torch.Tensor, z_near: float, z_far: float
) -> torch.Tensor:
    """Clip to [z_near, z_far], scale to [0, 255], C-truncate to uint8.

    depth == 0 stays 0 (undefined marker); the value is clipped to
    [0, 255] before the cast, so f32 rounding can never leave the u8 range.
    """
    zn = torch.tensor(np.float32(z_near), device=depth.device)
    zf = torch.tensor(np.float32(z_far), device=depth.device)
    val = torch.clamp(depth, float(np.float32(z_near)), float(np.float32(z_far)))
    val = (val - zn) / (zf - zn) * 255.0
    val = torch.where(depth == 0.0, 0.0, val)
    return torch.clamp(val, 0.0, 255.0).to(torch.uint8)


def colorize_turbo(norm_u8: torch.Tensor) -> torch.Tensor:
    """TURBO colormap (BGR, (..., 3) u8) with undefined pixels white
    (generate_color_map, disp_to_depth.py:34-43)."""
    lut = torch.from_numpy(TURBO_BGR_U8).to(norm_u8.device)
    rgb = lut[norm_u8.long()]
    return torch.where((norm_u8 == 0)[..., None], 255, rgb).to(torch.uint8)


def turbo_packed_lut() -> np.ndarray:
    """(256,) int32 packed-BGR TURBO table (B | G<<8 | R<<16), entry 0
    white: the undefined-pixel mask is exactly u8 == 0."""
    v = TURBO_BGR_U8.astype(np.int32)
    packed = v[:, 0] | (v[:, 1] << 8) | (v[:, 2] << 16)
    packed[0] = 0xFFFFFF
    return packed


def colorize_turbo_packed(norm_u8: torch.Tensor) -> torch.Tensor:
    """TURBO colormap as ONE int32 packed-BGR word per pixel (values
    < 2^24; unpack on the host with ``.view(uint8)``)."""
    lut = torch.from_numpy(turbo_packed_lut()).to(norm_u8.device)
    return lut[norm_u8.long()]
