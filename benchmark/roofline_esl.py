"""The bytes ESL's init must move a call, for ``esl_init_roofline``.

The init of a scan is kernel B into the camera's footprint box of the
rectified frame, kernel A (the search) on the box, kernel B back to the
camera.  Each scan counts, with the box as the search computes it (the
camera's footprint in the rectified frame, rows rounded down to a multiple
of 8, columns down to a multiple of 128 on the left and widened by the
900-column window on the right):

- the scan in: 4 B a distinct camera pixel the box reads;
- the two packed remap indices: 4 B a box pixel and 4 B a camera pixel;
- the box in and out of the search: 4 B a box pixel each way;
- the search's tables: 4 B a distinct element of the five per-row tables
  it reads (G: each binary-search step's midpoint and j0; N: j0 and the
  window's start; F, R: j0 - 1; C: the window's start - 1, j0 - 1 and its
  end - 1), replayed from the rectified projector times on the scan's lit
  box pixels (a dark pixel reads no table);
- the disparities back: 4 B a camera pixel written.

A call counts the sum over its scans.  Counted with the plain reference's
tables (``benchmark.reference.esl``), on its device.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.esl import MAX_DISP, MIN_DISP


def box(ref) -> tuple:
    """(r0, r1, c0, c1) of the search's box in the rectified frame."""
    H, W = ref.tabs["proj_rect"].shape
    fwd = ref.fwd.reshape(H, W) >= 0
    rows = torch.nonzero(fwd.any(1)).flatten()
    cols = torch.nonzero(fwd.any(0)).flatten()
    back = ref.back[ref.back >= 0].long()
    r = torch.cat([rows, back // W])
    c = torch.cat([cols, back % W])
    r0, r1 = int(r.min()) // 8 * 8, int(r.max()) + 1
    c0, c1 = int(c.min()) // 128 * 128, min(int(c.max()) + 1 + MAX_DISP, W)
    return r0, r1, c0, c1


def table_elements(lit_rows, lit_cols, cam, G, w_clip) -> int:
    """Distinct table elements the search reads for the lit box pixels
    (row, column, value)."""
    width = G.shape[1]
    last = width - 1
    row = lit_rows.long() * width
    c = lit_cols.long()
    g = G.reshape(-1)
    lo = c + MIN_DISP
    hi = torch.clamp_max(c + MAX_DISP, w_clip)
    left, right, mids = lo, hi, []
    for _ in range(math.ceil(math.log2(MAX_DISP - MIN_DISP)) + 1):
        m = torch.clamp_max(torch.div(left + right, 2, rounding_mode="floor"), last)
        mids.append(m)
        cond = g[row + m] >= cam
        right = torch.where(cond, m, right)
        left = torch.where(cond, left, m + 1)
    j0 = torch.minimum(right, hi)
    j0c = torch.clamp_max(j0, last)
    j0m1 = torch.clamp(j0 - 1, 0, last)
    reads = {"G": mids + [j0c], "F": [j0m1], "N": [j0c, torch.clamp_max(lo, last)],
             "R": [j0m1], "C": [torch.clamp(lo - 1, 0, last), j0m1, torch.clamp(hi - 1, 0, last)]}
    return sum(int(torch.unique(torch.cat([row + j for j in js])).numel())
               for js in reads.values())


def group_bytes(ref, scans) -> float:
    """The bytes of one call on ``scans`` (the module docstring)."""
    from benchmark.reference.esl import normalize

    H, W = ref.tabs["proj_rect"].shape
    r0, r1, c0, c1 = box(ref)
    width = -(-(c1 - c0) // 128) * 128
    proj = ref.proj_rect[r0:r1, c0:c1]
    proj = torch.cat([proj, proj.new_zeros((r1 - r0, width - (c1 - c0)))], 1)
    # G[j]: the value of the next nonzero projector time at a column >= j
    G = torch.cummin(torch.where(proj != 0, proj, math.inf).flip(1), 1).values.flip(1)
    box_fwd = ref.fwd.reshape(H, W)[r0:r1, c0:c1]
    box_px = (r1 - r0) * (c1 - c0)
    cam_px = ref.back.numel()
    cam_in = int(torch.unique(box_fwd[box_fwd >= 0]).numel())
    total = 0
    for scan in scans:
        cam = torch.from_numpy(normalize(scan)).to(ref.device)
        rect = ref.rectify(cam)[r0:r1, c0:c1]
        lit_rows, lit_cols = torch.nonzero(rect, as_tuple=True)
        elements = table_elements(lit_rows, lit_cols, rect[lit_rows, lit_cols], G,
                                  min(W - c0, width))
        total += 4 * cam_in + 4 * box_px + 4 * cam_px + 8 * box_px + 4 * elements + 4 * cam_px
    return float(total)
