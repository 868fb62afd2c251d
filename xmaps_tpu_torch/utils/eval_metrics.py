"""Depth evaluation metrics, exactly reproducing the reference formulas
(eval/create_evaluation_table.py:14-62): fill rate with a 1%-of-mean-depth
margin, RMSE over jointly valid pixels, Middlebury >1/5/10 cm percentages,
and the depth clipping/GT-masking loader."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EvaluationStats:
    fillrate: float
    rmse: float
    perc_1: float
    perc_5: float
    perc_10: float


def evaluation_stats(estimate: np.ndarray, groundtruth: np.ndarray) -> EvaluationStats:
    """reference create_evaluation_table.py:14-54"""
    gt = groundtruth
    margin = 0.01 * np.sum(gt[gt > 0]) / np.sum(gt > 0)

    diff = np.abs(gt - estimate)
    diff = np.where(gt == 0, 0, diff)
    npx = diff.shape[0] * diff.shape[1]
    n_empty = np.sum(gt == 0)
    fillrate = (np.sum(diff < margin) - n_empty) / (npx - n_empty)

    diff_sq = (gt - estimate) ** 2
    valid = (gt > 0) & (estimate > 0)
    rmse = float(np.sqrt(np.sum(diff_sq[valid]) / np.sum(valid))) if valid.any() else 0.0

    diff_abs = np.where(gt == 0, 0, np.abs(gt - estimate))
    perc_1 = 100 * np.sum(diff_abs > 1) / npx
    perc_5 = 100 * np.sum(diff_abs > 5) / npx
    perc_10 = 100 * np.sum(diff_abs > 10) / npx

    return EvaluationStats(
        fillrate=float(fillrate),
        rmse=rmse,
        perc_1=float(perc_1),
        perc_5=float(perc_5),
        perc_10=float(perc_10),
    )


def load_and_filter(depth: np.ndarray, gt: np.ndarray, min_depth: float,
                    max_depth: float) -> np.ndarray:
    """reference create_evaluation_table.py:57-62 (applied to arrays)."""
    result = depth.copy()
    result[result >= max_depth] = 0
    result[result <= min_depth] = 0
    result[gt == 0] = 0
    return result


def combine_depths(depth_list, min_depth: float, max_depth: float):
    """Temporal combination of per-frame depth maps (the MC3D/GT averaging
    of the reference, esl_utilities.py combine_mc3d:152-175): per-pixel
    mean over frames where defined after depth clipping, then a 3x3 median
    blur before the mean-depth statistic."""
    acc = None
    cnt = None
    for d in depth_list:
        d = d.copy()
        d[(d <= min_depth) | (d >= max_depth)] = 0
        if acc is None:
            acc = np.zeros_like(d, dtype=np.float64)
            cnt = np.zeros_like(d, dtype=np.int64)
        acc += d
        cnt += d > 0
    from xmaps_tpu_torch.utils.denoise import median_blur_3x3

    combined = np.where(cnt > 0, acc / np.maximum(cnt, 1), 0.0).astype(np.float32)
    combined = np.asarray(median_blur_3x3(combined))
    avg_depth = (
        float(combined[combined > 0].mean()) if (combined > 0).any() else 0.0
    )
    return combined, avg_depth
