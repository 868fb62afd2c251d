"""ESL-init disparity search over monotone rows (kernel A).

Port of ``xmaps_tpu.ops.pallas_esl``.  The reference's disparity_init
scans, for every nonzero rectified camera pixel (r, c), the projector row
window [c+5, c+900) for the nonzero value closest to the camera value --
an O(W x D) brute force (``models.esl_pipeline.disparity_init_dense``).
The rectified projector time surface is a monotone ramp along each row, so
the window scan collapses to a binary search over per-row scan tables:

    G[j] = value of the next nonzero at column >= j (suffix fill),
    F[j] = value of the last nonzero at column <= j (prefix fill),
    N[j] = column of the next nonzero >= j (W_pad if none),
    R[j] = first column of the equal-value run of the last nonzero <= j,
    C[j] = prefix count of nonzeros.

The tables depend on the projector surface only: ``esl_search_prep``
builds them once per calibration with torch scans, on the footprint box
padded to a multiple of 128 columns as the JAX package pads it (the
window clip ``W = min(W_loc, W_pad)`` reads the padding).  Per scan,
``esl_disparity_search`` runs one launch of kernel A (``csrc/esl.cu``) on a
CUDA tensor, or its plain version, a vectorised binary search with
``torch.gather`` along rows, on a CPU tensor.

Exactness: bit-identical to the brute force whenever every row's nonzero
values are nondecreasing (``rows_monotone``); callers check it at setup.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from xmaps_tpu_torch.ops import _build

__all__ = [
    "rows_monotone",
    "footprint_box",
    "esl_search_prep",
    "esl_disparity_search",
    "esl_search_box",
    "esl_search_box_plain",
    "box_search_args",
]

#: the JAX kernel's lane-group gather reaches windows of at most this width
MAX_WINDOW = 9 * 128 - 127


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def rows_monotone(proj_rect: np.ndarray) -> bool:
    """Whether each row's nonzero values are nondecreasing (the fast
    search's precondition)."""
    p = np.asarray(proj_rect)
    if not bool(((p == 0) | (p > 0)).all()):
        # _prep_rows' prefix fill uses 0 as the "no value yet" sentinel,
        # so negative nonzero values are out of contract
        return False
    filled = np.where(p != 0, p, -np.inf)
    running = np.maximum.accumulate(filled, axis=1)
    prev = np.concatenate(
        [np.full((p.shape[0], 1), -np.inf), running[:, :-1]], axis=1
    )
    return bool(((p == 0) | (p >= prev)).all())


def footprint_box(
    full_shape: tuple,
    row_range: tuple,
    col_range: tuple,
    max_disp: int = 900,
) -> tuple:
    """Crop box (r0, r1, c0, c1) the search computes for the given
    camera-footprint bounds, as the JAX package's: rows rounded down to a
    multiple of 8, columns down to a multiple of 128 on the left and
    widened by the disparity window on the right.  Callers that pre-crop
    their inputs must use exactly this box."""
    H, W = full_shape
    r0 = max((int(row_range[0]) // 8) * 8, 0)
    r1 = min(int(row_range[1]), H)
    c0 = max((int(col_range[0]) // 128) * 128, 0)
    c1 = min(int(col_range[1]) + max_disp, W)
    return r0, r1, c0, c1


def _box(shape, row_range, col_range, full_shape, max_disp):
    """(H, W, r0, r1, c0, c1, pre_cropped) for the search's arguments."""
    if full_shape is not None:
        assert row_range is not None and col_range is not None
        H, W = full_shape
        r0, r1, c0, c1 = footprint_box(full_shape, row_range, col_range, max_disp)
        assert tuple(shape) == (r1 - r0, c1 - c0), (
            f"pre-cropped input {tuple(shape)} does not match footprint_box "
            f"{(r1 - r0, c1 - c0)}"
        )
        return H, W, r0, r1, c0, c1, True
    H, W = shape
    r0, r1, c0, c1 = 0, H, 0, W
    if row_range is not None:
        r0 = max((int(row_range[0]) // 8) * 8, 0)
        r1 = min(int(row_range[1]), H)
    if col_range is not None:
        c0 = max((int(col_range[0]) // 128) * 128, 0)
        c1 = min(int(col_range[1]) + max_disp, W)
    return H, W, r0, r1, c0, c1, False


def _prep_rows(proj: torch.Tensor):
    """Per-row scan tables (G, F, N, R, C) of a (H, W_pad) float32 surface."""
    H, W_pad = proj.shape
    nz = proj != 0
    j = torch.arange(W_pad, dtype=torch.int32, device=proj.device).expand(H, W_pad)
    G = torch.cummin(torch.where(nz, proj, math.inf).flip(1), 1).values.flip(1)
    N = torch.cummin(torch.where(nz, j, W_pad).flip(1), 1).values.flip(1)
    F = torch.cummax(torch.where(nz, proj, 0.0), 1).values
    prevF = torch.cat([torch.zeros_like(F[:, :1]), F[:, :-1]], 1)
    newrun = nz & (proj != prevF)
    R = torch.cummax(torch.where(newrun, j, -1), 1).values
    C = torch.cumsum(nz.int(), 1, dtype=torch.int32)
    return tuple(t.contiguous() for t in (G, F, N, R, C))


def esl_search_prep(
    proj_rect,
    max_disp: int = 900,
    row_range: Optional[tuple] = None,
    col_range: Optional[tuple] = None,
    full_shape: Optional[tuple] = None,
):
    """The search's per-row scan tables (G, F, N, R, C) for
    :func:`esl_disparity_search` called with the same cropping arguments,
    on ``proj_rect``'s device (a NumPy array goes to the CPU).  Each is
    (Hc, W_pad): the box's rows, its columns padded with zeros to a
    multiple of 128.  None for an empty box."""
    proj = torch.as_tensor(proj_rect, dtype=torch.float32)
    H, W, r0, r1, c0, c1, pre_cropped = _box(
        proj.shape, row_range, col_range, full_shape, max_disp
    )
    if r1 <= r0 or c1 <= c0:
        return None
    if not pre_cropped:
        proj = proj[r0:r1, c0:c1]
    Wc = c1 - c0
    proj = torch.nn.functional.pad(proj, (0, _round_up(Wc, 128) - Wc))
    return _prep_rows(proj)


def esl_search_box_plain(cam, tables, *, w_clip, min_disp, max_disp, steps):
    """Plain PyTorch version of :func:`esl_search_box` (any device)."""
    G, F, N, R, C = tables
    Hc, Wc = cam.shape
    last = G.shape[1] - 1
    c = torch.arange(Wc, dtype=torch.int32, device=cam.device).expand(Hc, Wc)

    def at(table, j):
        return torch.gather(table, 1, j.long())

    lo = c + min_disp
    hi = torch.clamp_max(c + max_disp, w_clip)
    l, r = lo, hi
    for _ in range(steps):
        m = torch.clamp_max(torch.div(l + r, 2, rounding_mode="floor"), last)
        cond = at(G, m) >= cam
        r = torch.where(cond, m, r)
        l = torch.where(cond, l, m + 1)
    j0 = torch.minimum(r, hi)
    j0c = torch.clamp_max(j0, last)
    j0m1 = torch.clamp(j0 - 1, 0, last)

    w_u, cu = at(G, j0c), at(N, j0c)
    w_l, rl = at(F, j0m1), at(R, j0m1)
    cnt_lo = at(C, torch.clamp(lo - 1, 0, last))
    cnt_j0 = at(C, j0m1)
    cnt_hi = at(C, torch.clamp(hi - 1, 0, last))
    n_lo = at(N, torch.clamp_max(lo, last))

    cnt_before_lo = torch.where(lo >= 1, cnt_lo, 0)
    has_upper = (j0 < hi) & (cu < hi)
    has_lower = (j0 > lo) & (cnt_j0 - cnt_before_lo >= 1)
    cl = torch.maximum(rl, n_lo)
    du2 = (w_u - cam) * (w_u - cam)
    dl2 = (cam - w_l) * (cam - w_l)
    # np.argmin first minimum: ties go to the lower (smaller) column
    pick_lower = has_lower & (~has_upper | (dl2 <= du2))
    best = torch.where(pick_lower, cl, cu)
    chosen = has_lower | has_upper
    ok = (cam != 0) & (cnt_hi - cnt_before_lo > 1) & chosen & (c < w_clip)
    return torch.where(ok, best - c, 0).float()


def esl_search_box(cam, tables, *, w_clip, min_disp, max_disp, steps):
    """(Hc, Wc) float32 camera box + prep tables -> (Hc, Wc) float32
    integer-valued disparities.  Kernel A on a CUDA tensor (replacing the
    TPU kernel ``xmaps_tpu/ops/pallas_esl.py:281``), the plain version on a
    CPU tensor."""
    dev = cam.device
    kw = dict(w_clip=w_clip, min_disp=min_disp, max_disp=max_disp, steps=steps)
    if dev.type == "cpu":
        return esl_search_box_plain(cam, tables, **kw)
    if dev.type != "cuda":
        raise ValueError(f"esl_disparity_search: unsupported device {dev}")
    Hc, Wc = cam.shape
    W_pad = tables[0].shape[1]
    if W_pad < Wc:
        raise ValueError(f"esl_disparity_search: tables {W_pad} wide < box {Wc}")
    for name, a, dtype, shape in (
        ("cam", cam, torch.float32, (Hc, Wc)),
        *((n, t, d, (Hc, W_pad)) for n, t, d in zip(
            "GFNRC", tables,
            (torch.float32, torch.float32, torch.int32, torch.int32, torch.int32))),
    ):
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(
                f"esl_disparity_search: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    out = torch.empty((Hc, Wc), dtype=torch.float32, device=dev)
    _build.launch(
        dev, "esl_disparity_search", "esl_disparity_search",
        cam.data_ptr(), Hc, Wc, *(t.data_ptr() for t in tables), W_pad,
        w_clip, min_disp, max_disp, steps, out.data_ptr(),
    )
    return out


def box_search_args(W: int, c0: int, c1: int, min_disp: int = 5, max_disp: int = 900) -> dict:
    """Keyword arguments of :func:`esl_search_box` for the box [c0, c1) of
    a rect frame W wide: windows clip at the real data's width (W - c0 in
    box coordinates) or at the padded width, as the JAX kernel's ``W``."""
    return dict(
        w_clip=min(W - c0, _round_up(c1 - c0, 128)), min_disp=min_disp,
        max_disp=max_disp, steps=int(np.ceil(np.log2(max_disp - min_disp))) + 1,
    )


def esl_disparity_search(
    cam_rect,
    proj_rect,
    min_disp: int = 5,
    max_disp: int = 900,
    row_range: Optional[tuple] = None,
    col_range: Optional[tuple] = None,
    full_shape: Optional[tuple] = None,
    emit_crop: bool = False,
    prep=None,
) -> torch.Tensor:
    """Binary-search ESL-init disparity over monotone rows.
    ``cam_rect`` / ``proj_rect``: (H, W) float32 tensors (or NumPy, taken
    to the CPU); returns (H, W) float32 on cam's device.

    ``prep``: the tables of :func:`esl_search_prep` for the same cropping
    arguments; then ``proj_rect`` may be None.  ``row_range`` /
    ``col_range``: (lo, hi) bounds holding EVERY nonzero camera pixel; the
    search then runs on :func:`footprint_box` only.  ``full_shape``: the
    full rect (H, W) when the inputs are ALREADY cropped to that box.
    ``emit_crop`` returns the box instead of pasting it into a zero map.
    """
    assert 1 <= min_disp and max_disp <= MAX_WINDOW, (
        f"unsupported disparity window [{min_disp}, {max_disp})"
    )
    assert proj_rect is not None or prep is not None
    cam = torch.as_tensor(cam_rect, dtype=torch.float32)
    H, W, r0, r1, c0, c1, pre_cropped = _box(
        cam.shape, row_range, col_range, full_shape, max_disp
    )
    if r1 <= r0 or c1 <= c0:
        shape = (max(r1 - r0, 0), max(c1 - c0, 0)) if emit_crop else (H, W)
        return torch.zeros(shape, dtype=torch.float32, device=cam.device)
    if not pre_cropped:
        cam = cam[r0:r1, c0:c1]
    cam = cam.contiguous()
    if prep is None:
        proj = torch.as_tensor(proj_rect, dtype=torch.float32).to(cam.device)
        prep = esl_search_prep(proj[r0:r1, c0:c1] if not pre_cropped else proj,
                               max_disp)
    W_pad = _round_up(c1 - c0, 128)
    assert tuple(prep[0].shape) == (r1 - r0, W_pad), (
        f"prep tables {tuple(prep[0].shape)} do not match the box "
        f"{(r1 - r0, W_pad)}: esl_search_prep needs the same cropping arguments"
    )
    out = esl_search_box(cam, prep, **box_search_args(W, c0, c1, min_disp, max_disp))
    if emit_crop or (row_range is None and col_range is None):
        return out
    full = torch.zeros((H, W), dtype=torch.float32, device=cam.device)
    full[r0:r1, c0:c1] = out
    return full
