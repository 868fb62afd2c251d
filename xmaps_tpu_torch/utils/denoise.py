"""Dense image filters for the offline eval baselines, as torch ops.

Port of ``xmaps_tpu.utils.denoise``'s 3x3 median blur (plain XLA there,
not Pallas; reference: eval/mc3d_baseline.py:131, eval/esl_utilities.py:172
`cv2.medianBlur`), exact.  It takes a tensor (or a NumPy array, taken to
the CPU) and runs on its device.  ESL's denoise (the bilateral filter and
the split-Bregman TV denoise) is ``ops.esl_denoise``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["median_blur_3x3", "pad_edge"]


def pad_edge(img: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W) -> (..., H + 2r, W + 2r), each slice's edges replicated."""
    H, W = img.shape[-2:]
    padded = F.pad(img.reshape(-1, 1, H, W), (r, r, r, r), mode="replicate")
    return padded.reshape(*img.shape[:-2], H + 2 * r, W + 2 * r)


def median_blur_3x3(img) -> torch.Tensor:
    """3x3 median with edge replication (cv2.medianBlur semantics)."""
    img = torch.as_tensor(img)
    H, W = img.shape
    padded = pad_edge(img, 1)
    stack = torch.stack(
        [padded[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
        dim=0,
    )
    return torch.sort(stack, dim=0).values[4]
