"""ESL's denoise over a group of scans (kernel D).

The reference's filters of the refined depth (eval/compute_depth_esl.py:242
``cv2.bilateralFilter(depth, 5, 3, 3)``, then eval/esl_utilities.py:194-224's
``pylops`` split-Bregman TV-L2 denoise) as the port computes them:
:func:`bilateral_filter` and :func:`tv_denoise_split_bregman`, the plain
versions (ports of ``xmaps_tpu.utils.denoise``, plain XLA there).
:func:`esl_denoise` runs both as kernel D (``csrc/esl_denoise.cu``) on CUDA
tensors, 1 + ``niter`` launches a call, or as the plain versions on CPU
tensors.  The plain versions are about 5,566 elementwise launches a group of
12 ESL scans; kernel D does the same arithmetic in shared memory and equals
them on the card bit for bit.

The plain versions follow the JAX package's operation order, but cannot be
bit-equal to it: ``exp`` differs between the libraries, and XLA on the CPU
contracts multiply-adds into FMAs where PyTorch rounds each operation (the
tests state the tolerance).  They take (..., H, W): each (H, W) slice is
filtered alone, with the operations of a 2-D call in the same order, so a
slice of a stack is bit-equal to the 2-D call on it.
"""

from __future__ import annotations

import numpy as np
import torch

from xmaps_tpu_torch.ops import _build
from xmaps_tpu_torch.utils.denoise import pad_edge

__all__ = [
    "MAX_RADIUS",
    "MAX_INNER",
    "MAX_SCANS",
    "MIN_DIAG",
    "MAX_DIAG",
    "bilateral_filter",
    "tv_denoise_split_bregman",
    "denoise_scalars",
    "esl_denoise",
]

#: the largest bilateral window half-width (``d // 2``) kernel D's tile holds
MAX_RADIUS = 4
#: the most Jacobi sweeps an outer TV iteration's tile halo holds
MAX_INNER = 16
#: the most scans one launch takes (the grid's z extent)
MAX_SCANS = 65535
#: the TV sweeps' divisor mu + 4 lam the kernel's division by a reciprocal takes
MIN_DIAG, MAX_DIAG = 2.0**-20, 2.0**20


def bilateral_filter(
    img, d: int = 5, sigma_color: float = 3.0, sigma_space: float = 3.0
) -> torch.Tensor:
    """Bilateral filter over a (d x d) window (cv2.bilateralFilter args),
    of an (H, W) image or each slice of an (..., H, W) stack.

    w(p, q) = exp(-|I(p)-I(q)|^2 / 2sc^2 - |p-q|^2 / 2ss^2), normalized.
    Border: replicate (OpenCV default).  The two scales are float32, as
    the JAX package's traced arguments.
    """
    img = torch.as_tensor(img, dtype=torch.float32)
    H, W = img.shape[-2:]
    r = d // 2
    padded = pad_edge(img, r)

    def f32(v):  # filled on the device: a host tensor copied in would wait for it
        return torch.full((), v, dtype=torch.float32, device=img.device)

    sc, ss = f32(sigma_color), f32(sigma_space)
    inv2sc = f32(1.0) / (2.0 * sc * sc)
    inv2ss = f32(1.0) / (2.0 * ss * ss)
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            q = padded[..., r + dy:r + dy + H, r + dx:r + dx + W]
            diff = q - img
            w = torch.exp(-(diff * diff) * inv2sc - (dy * dy + dx * dx) * inv2ss)
            num = num + w * q
            den = den + w
    return num / den


def _shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """a shifted so out[..., y, x] = a[..., y+dy, x+dx]; vacated cells = 0."""
    out = torch.zeros_like(a)
    H, W = a.shape[-2:]
    out[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = (
        a[..., max(dy, 0):H - max(-dy, 0), max(dx, 0):W - max(-dx, 0)]
    )
    return out


def _grad_x(u):  # backward difference, no edge wrap (edge row/col = 0)
    return u - _shift2d(u, 0, -1)


def _grad_y(u):
    return u - _shift2d(u, -1, 0)


def _div(px, py):  # negative adjoint of (grad_y, grad_x)
    return (_shift2d(px, 0, 1) - px) + (_shift2d(py, 1, 0) - py)


def _shrink(v, t):
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - t, 0.0)


def tv_denoise_split_bregman(
    y,
    mu: float = 0.5,
    eps: float = 0.1,
    niter: int = 20,
    niter_inner: int = 10,
) -> torch.Tensor:
    """Anisotropic TV-L2 denoise via split Bregman (Goldstein-Osher), of
    an (H, W) image or each slice of an (..., H, W) stack.

    Solves min_u mu/2 ||u - y||^2 + eps (|grad_x u|_1 + |grad_y u|_1) --
    the objective of the reference's pylops SplitBregman call
    (esl_utilities.py:206-223; same mu=0.5, eps=0.1, 20 outer / 10 inner
    iterations).  Splitting d = grad u with penalty lam/2 ||d - grad u -
    b||^2:

      u:  (mu I + lam grad^T grad) u = mu y - lam div(d - b)   [Jacobi sweeps]
      d:  shrink(grad u + b, eps / lam)
      b:  b += grad u - d

    The inner solve uses fixed-count Jacobi sweeps instead of pylops' LSQR.
    ``mu`` and ``eps`` are float32 scalars, as the JAX package's traced
    arguments, so every division is a true division.
    """
    y = torch.as_tensor(y, dtype=torch.float32)
    mu = torch.full((), mu, dtype=torch.float32, device=y.device)
    eps = torch.full((), eps, dtype=torch.float32, device=y.device)
    lam = 2.0 * eps  # standard penalty choice; convergence-rate only
    thresh = eps / lam
    diag = mu + 4.0 * lam

    u = y
    dx = torch.zeros_like(y)
    dy_ = torch.zeros_like(y)
    bx = torch.zeros_like(y)
    by = torch.zeros_like(y)
    for _ in range(niter):
        rhs = mu * y - lam * _div(dx - bx, dy_ - by)
        for _ in range(niter_inner):
            neigh = (
                _shift2d(u, 0, 1)
                + _shift2d(u, 0, -1)
                + _shift2d(u, 1, 0)
                + _shift2d(u, -1, 0)
            )
            u = (rhs + lam * neigh) / diag
        gx = _grad_x(u)
        gy = _grad_y(u)
        dx = _shrink(gx + bx, thresh)
        dy_ = _shrink(gy + by, thresh)
        bx = bx + gx - dx
        by = by + gy - dy_
    return u


def denoise_scalars(sigma_color: float, sigma_space: float, mu: float, eps: float) -> dict:
    """The float32 scalars the plain versions compute on the device, as
    Python floats for kernel D: ``inv2sc``, ``inv2ss`` (the bilateral's),
    ``lam``, ``thresh``, ``diag`` (the TV denoise's), ``mu``."""
    f = np.float32
    with np.errstate(all="ignore"):
        sc, ss, mu32, eps32 = f(sigma_color), f(sigma_space), f(mu), f(eps)
        lam = f(2.0) * eps32
        out = dict(inv2sc=f(1.0) / (f(2.0) * sc * sc), inv2ss=f(1.0) / (f(2.0) * ss * ss),
                   lam=lam, thresh=eps32 / lam, diag=mu32 + f(4.0) * lam, mu=mu32)
    return {k: float(v) for k, v in out.items()}


def esl_denoise(
    depth: torch.Tensor,
    d: int = 5,
    sigma_color: float = 3.0,
    sigma_space: float = 3.0,
    mu: float = 0.5,
    eps: float = 0.1,
    niter: int = 20,
    niter_inner: int = 10,
) -> torch.Tensor:
    """``tv_denoise_split_bregman(bilateral_filter(depth, d, sigma_color,
    sigma_space), mu, eps, niter, niter_inner)`` of an (H, W) scan or each
    scan of an (F, H, W) group, ``depth`` contiguous float32.  Kernel D on
    CUDA tensors (one launch for the bilateral, one an outer TV iteration),
    the plain versions on CPU tensors; anything else raises, as do a window
    half-width ``d // 2`` above :data:`MAX_RADIUS` or ``niter_inner`` above
    :data:`MAX_INNER` (kernel D's tiles) and a TV divisor ``mu + 8 eps``
    outside [:data:`MIN_DIAG`, :data:`MAX_DIAG`] (its division), on either
    device."""
    dev = depth.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"esl_denoise: unsupported device {dev}")
    shape = tuple(depth.shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"esl_denoise: depth must be (H, W) or (F, H, W), got {shape}")
    if depth.dtype != torch.float32 or not depth.is_contiguous():
        raise ValueError(
            f"esl_denoise: depth must be a contiguous float32 tensor, got {depth.dtype}"
            f"{'' if depth.is_contiguous() else ', not contiguous'}")
    r = int(d) // 2
    if not 0 <= r <= MAX_RADIUS:
        raise ValueError(f"esl_denoise: window d = {d} (half-width {r}) outside the "
                         f"half-widths [0, {MAX_RADIUS}] of kernel D's tile")
    if not 0 <= int(niter_inner) <= MAX_INNER:
        raise ValueError(f"esl_denoise: niter_inner {niter_inner} outside [0, {MAX_INNER}] "
                         f"(kernel D's tile)")
    if int(niter) < 0:
        raise ValueError(f"esl_denoise: niter must be at least 0, got {niter}")
    s = denoise_scalars(sigma_color, sigma_space, mu, eps)
    if not MIN_DIAG <= s["diag"] <= MAX_DIAG:
        raise ValueError(f"esl_denoise: mu + 8 eps = {s['diag']} outside [{MIN_DIAG}, "
                         f"{MAX_DIAG}] (kernel D's division)")
    if dev.type == "cpu":
        return tv_denoise_split_bregman(bilateral_filter(depth, d, sigma_color, sigma_space),
                                        mu, eps, int(niter), int(niter_inner))
    F = 1 if len(shape) == 2 else shape[0]
    if F > MAX_SCANS:
        raise ValueError(f"esl_denoise: {F} scans in one call, at most {MAX_SCANS}")
    return _kernel_d(depth, r, s, int(niter), int(niter_inner))


def _kernel_d(depth: torch.Tensor, r: int, s: dict, niter: int, niter_inner: int):
    """Kernel D's 1 + ``niter`` launches on ``depth`` (checked by
    :func:`esl_denoise`), ``s`` its :func:`denoise_scalars`."""
    dev = depth.device
    shape = tuple(depth.shape)
    F = 1 if len(shape) == 2 else shape[0]
    H, W = shape[-2:]
    y = torch.empty_like(depth)
    _build.launch(dev, "esl_denoise", "esl_bilateral", depth.data_ptr(), F, H, W, r,
                  s["inv2sc"], s["inv2ss"], y.data_ptr())
    # u and b ping-pong between two buffer sets: a launch reads the previous
    # launch's while its neighbours' halos may still read them
    u = [torch.empty_like(depth) for _ in range(2)]
    b = [torch.empty((2, *shape), dtype=torch.float32, device=dev) for _ in range(2)]
    u_in, b_in = y, None
    for k in range(niter):
        u_out = u[k % 2]
        b_out = b[k % 2] if 0 < k < niter - 1 else None
        _build.launch(
            dev, "esl_denoise", "esl_tv_iteration",
            y.data_ptr(), u_in.data_ptr(),
            *((b_in[0].data_ptr(), b_in[1].data_ptr()) if b_in is not None else (None, None)),
            F, H, W, s["mu"], s["lam"], s["thresh"], s["diag"], niter_inner, int(k == 0),
            u_out.data_ptr(),
            *((b_out[0].data_ptr(), b_out[1].data_ptr()) if b_out is not None else (None, None)),
        )
        u_in, b_in = u_out, b_out
    return u_in
