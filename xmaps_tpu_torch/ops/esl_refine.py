"""ESL's depth refinement over a group of scans (kernel R).

The reference's refinement (eval/compute_depth_esl.py depth_optimization,
:104-129) as the port computes it: a bounded two-level grid search of the
closed-form window cost of every defined depth pixel (see
:func:`esl_refine_plain`).  :func:`esl_refine` runs it as one launch of
kernel R (``csrc/esl_refine.cu``) on CUDA tensors, or as the plain version
on CPU tensors.  The plain version is about 13,500 elementwise launches a
group of 12 ESL scans; kernel R does the same arithmetic a pixel a thread in
registers and equals the plain version on the card bit for bit.

``models.esl_pipeline.depth_optimization_dense`` is the entry point the
evaluation, the ESL engine and the tests call.
"""

from __future__ import annotations

import numpy as np
import torch

from xmaps_tpu_torch.ops import _build

__all__ = [
    "MAX_W",
    "MAX_SCANS",
    "OOB_COST",
    "CONSTANTS",
    "to_int32_saturating",
    "constant_block",
    "esl_refine",
    "esl_refine_plain",
]

#: the largest window half-width w kernel R's shared tile holds (its MAX_W)
MAX_W = 8
#: the most scans one launch takes (the grid's z extent)
MAX_SCANS = 65535
OOB_COST = 1.0e10  # dominates any in-bounds quadratic cost (reference: 100000)
INT32_MAX = 2**31 - 1

#: the constant block's first 32 float32 slots (kernel R's C_* offsets; the
#: rest of the header is 0), then the (2w + 1)^2 tap weights, dy outer
CONSTANTS = (
    "R00", "R01", "R02", "R10", "R11", "R12", "R20", "R21", "R22", "T0", "T1", "T2",
    "fx", "cx", "fy", "cy", "k1", "k2", "p1", "p2", "k3", "2p1", "2p2",
    "inv_n", "B2", "inv_p03", "inv_iters", "tiny", "oob",
)
_HEADER = 32


def _f32(v) -> float:
    """A Python scalar rounded to float32, as JAX rounds a weakly typed
    constant that meets a float32 array."""
    return float(np.float32(v))


def to_int32_saturating(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 truncation as XLA converts: values beyond the int32
    range saturate and NaN becomes 0 (a plain cast is undefined there)."""
    big = x >= 2.0**31
    t = torch.where(torch.isnan(x) | big, 0.0, x).clamp_min(-(2.0**31)).int()
    return torch.where(big, INT32_MAX, t)


def constant_block(plan, iters: int) -> np.ndarray:
    """Kernel R's constants for ``plan`` (a ``models.esl_pipeline.
    RefinePlan``) and ``iters``: each Python number of
    :func:`esl_refine_plain` as the float32 it becomes where it meets a
    tensor, laid out as :data:`CONSTANTS` names them, then the tap weights
    ``_f32(b)``."""
    w = plan.w
    Hp, Wp = plan.proj_h, plan.proj_w
    inv_n = 1.0 / (Wp * Hp)
    taps, B2 = [], 0.0
    for dy in range(-w, w + 1):
        for dx in range(-w, w + 1):
            b = (dx * Hp + dy) * inv_n
            taps.append(b)
            B2 += b * b
    pK = plan.proj_K
    k1, k2, p1, p2, k3 = [float(v) for v in np.resize(plan.proj_D, 5)]
    head = [
        *(float(v) for v in np.asarray(plan.R).ravel()),
        *(float(v) for v in np.asarray(plan.T).reshape(3)),
        float(pK[0, 0]), float(pK[0, 2]), float(pK[1, 1]), float(pK[1, 2]),
        k1, k2, p1, p2, k3, 2 * p1, 2 * p2,
        inv_n, B2,
        float(np.float32(1.0) / np.float32(plan.p03)),
        float(np.float32(1.0) / np.float32(iters)),
        1e-12, OOB_COST,
    ]
    assert len(head) == len(CONSTANTS)
    head += [0.0] * (_HEADER - len(head))
    return np.array(head + taps, dtype=np.float32)


def esl_refine_plain(depth_init, cam_image, plan, iters: int = 64):
    """Refinement of every defined depth pixel at once (reference
    depth_optimization, :104-129), on depth_init's device: of one (H, W)
    scan, or of each scan of an (F, H, W) group (``cam_image`` the same
    shape), with the operations of a one-scan call in the same order, so
    each scan of a group is bit-equal to its one-scan call.

    The cost is piecewise-constant in depth (integer projector pixel
    casts), so the bounded minimization is a two-level dense grid search:
    ``iters`` samples over [depth - diff, depth + diff], then ``iters``
    more within one coarse step of the best sample.  First minimum wins
    (np.argmin semantics).

    The float32 rounding points are the JAX program's: Python constants
    round to float32 where they meet an array, ``B2`` is summed in float64
    on the host, XLA turns the divisions by the constants ``p03`` and
    ``iters`` into multiplications by their float32 reciprocals, and the
    float -> int casts saturate.
    """
    depth0 = torch.as_tensor(depth_init, dtype=torch.float32)
    dev = depth0.device
    w = plan.w
    ws = plan.window_size
    Hp, Wp = plan.proj_h, plan.proj_w
    K = (2 * w + 1) ** 2
    inv_n = 1.0 / (Wp * Hp)

    # stencil sums of the camera image (computed once per scan)
    cam = torch.as_tensor(cam_image, dtype=torch.float32).to(dev)
    H, W = cam.shape[-2:]
    pad = torch.nn.functional.pad(cam, (w, w, w, w))
    S0 = torch.zeros_like(cam)
    S1 = torch.zeros_like(cam)
    X1 = torch.zeros_like(cam)
    B2 = 0.0
    for dy in range(-w, w + 1):
        for dx in range(-w, w + 1):
            c = pad[..., w + dy:w + dy + H, w + dx:w + dx + W]
            b = (dx * Hp + dy) * inv_n
            S0 = S0 + c * c
            S1 = S1 + c
            X1 = X1 + c * _f32(b)
            B2 += b * b
    base = (S0 - 2.0 * X1) + _f32(B2)

    xn, yn = plan.rays(dev)
    R = [[float(v) for v in row] for row in plan.R]
    T = [float(v) for v in plan.T]
    pK = plan.proj_K
    k1, k2, p1, p2, k3 = [float(v) for v in np.resize(plan.proj_D, 5)]
    # filled on the device: a host tensor copied in would wait for the card
    tiny = torch.full((), _f32(1e-12), device=dev)
    oob = torch.full((), _f32(OOB_COST), device=dev)

    def cost(rho):
        # project_and_backproject_punkt (reference :27-42), elementwise
        X = xn * rho
        Y = yn * rho
        Z = rho
        xp = R[0][0] * X + R[0][1] * Y + R[0][2] * Z + T[0]
        yp = R[1][0] * X + R[1][1] * Y + R[1][2] * Z + T[1]
        zp = R[2][0] * X + R[2][1] * Y + R[2][2] * Z + T[2]
        zp = torch.where(zp == 0, tiny, zp)
        u = xp / zp
        v = yp / zp
        r2 = u * u + v * v
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        ud = u * radial + (2 * p1) * u * v + p2 * (r2 + 2 * u * u)
        vd = v * radial + p1 * (r2 + 2 * v * v) + (2 * p2) * u * v
        px = float(pK[0, 0]) * ud + float(pK[0, 2])
        py = float(pK[1, 1]) * vd + float(pK[1, 2])
        xi = to_int32_saturating(px)  # trunc toward zero (reference :50)
        yi = to_int32_saturating(py)
        inb = (
            (yi - w > 0) & (yi + w < Hp) & (xi - w > 0) & (xi + w < Wp)
        )  # reference :54-59 (strict; int32 arithmetic wraps, as in XLA)
        a = (xi * Hp + yi).float() * _f32(inv_n)
        quad = base - (2.0 * a) * S1 + (K * a) * a
        return torch.where(inb, quad, oob)

    # reference :110 bound radius; XLA: x / p03 -> x * f32(1 / p03)
    diff = (depth0 * depth0) * float(np.float32(1.0) / np.float32(plan.p03))
    lo0 = depth0 - diff
    hi0 = depth0 + diff
    inv_iters = float(np.float32(1.0) / np.float32(iters))

    def grid_minimize(center, radius, n):
        # n+1 evenly spaced samples, clamped to the reference's bounds;
        # center is sampled exactly at i = n/2 (n even)
        step = (2.0 * radius) * inv_iters
        best_cost = torch.full_like(center, torch.inf)
        best_x = center
        start = center - radius
        for i in range(n + 1):
            x = torch.clamp(start + float(i) * step, lo0, hi0)
            f = cost(x)
            better = f < best_cost
            best_cost = torch.where(better, f, best_cost)
            best_x = torch.where(better, x, best_x)
        return best_x, step

    x1, step1 = grid_minimize(depth0, diff, iters)
    refined, _ = grid_minimize(x1, step1, iters)

    # reference :107-108: only pixels with depth > 0, at least window_size
    # away from every border, are optimized; the rest stay 0.
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    in_region = (ys >= ws) & (ys < H - ws) & (xs >= ws) & (xs < W - ws)
    return torch.where((depth0 > 0) & in_region, refined, 0.0)


def esl_refine(depth0: torch.Tensor, cam: torch.Tensor, plan, iters: int = 64) -> torch.Tensor:
    """The refined depth of an (H, W) scan or an (F, H, W) group:
    ``depth0`` the init's depth, ``cam`` the normalised camera image with
    its empty pixels filled, both contiguous float32 of one shape on one
    device; ``plan`` a ``models.esl_pipeline.RefinePlan`` of window
    half-width at most :data:`MAX_W`.  Kernel R on CUDA tensors (one launch), the plain
    version on CPU tensors; anything else raises."""
    dev = depth0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"esl_refine: unsupported device {dev}")
    shape = tuple(depth0.shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"esl_refine: depth0 must be (H, W) or (F, H, W), got {shape}")
    for name, a in (("depth0", depth0), ("cam", cam)):
        if (a.device != dev or a.dtype != torch.float32 or tuple(a.shape) != shape
                or not a.is_contiguous()):
            raise ValueError(
                f"esl_refine: {name} must be a contiguous float32 tensor of shape {shape} on "
                f"{dev}, got {a.dtype} {tuple(a.shape)} on {a.device}"
                f"{'' if a.is_contiguous() else ', not contiguous'}"
            )
    if not 0 <= plan.w <= MAX_W:
        raise ValueError(f"esl_refine: window half-width {plan.w} outside [0, {MAX_W}] "
                         f"(kernel R's tile)")
    if int(iters) < 1:
        raise ValueError(f"esl_refine: iters must be at least 1, got {iters}")
    if dev.type == "cpu":
        return esl_refine_plain(depth0, cam, plan, iters)
    F = 1 if len(shape) == 2 else shape[0]
    H, W = shape[-2:]
    if F > MAX_SCANS:
        raise ValueError(f"esl_refine: {F} scans in one call, at most {MAX_SCANS}")
    xn, yn = plan.rays(dev)
    if tuple(xn.shape) != (H, W):
        raise ValueError(f"esl_refine: the plan's rays are {tuple(xn.shape)}, the scans "
                         f"{(H, W)}")
    consts = plan.constants(dev, int(iters))
    out = torch.empty_like(depth0)
    _build.launch(
        dev, "esl_refine", "esl_refine",
        depth0.data_ptr(), cam.data_ptr(), xn.data_ptr(), yn.data_ptr(), consts.data_ptr(),
        F, H, W, plan.w, plan.window_size, plan.proj_h, plan.proj_w, int(iters),
        out.data_ptr(),
    )
    return out
