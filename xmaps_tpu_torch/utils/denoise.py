"""Dense image filters for the offline eval baselines, as torch ops.

Port of ``xmaps_tpu.utils.denoise`` (plain XLA there, not Pallas):

- 3x3 median blur             (reference: eval/mc3d_baseline.py:131,
                               eval/esl_utilities.py:172 `cv2.medianBlur`)
- bilateral filter            (reference: eval/compute_depth_esl.py:242
                               `cv2.bilateralFilter(depth, 5, 3, 3)`)
- split-Bregman TV-L2 denoise (reference: eval/esl_utilities.py:194-224
                               `pylops.optimization.sparsity.SplitBregman`)

Each takes a tensor (or a NumPy array, taken to the CPU) and runs on its
device.  The median is exact.  The other two follow the JAX package's
operation order, but cannot be bit-equal to it: ``exp`` differs between
the libraries, and XLA on the CPU contracts multiply-adds into FMAs where
PyTorch rounds each operation (the tests state the tolerance).  They take
(..., H, W): each (H, W) slice is filtered alone, with the operations of a
2-D call in the same order, so a slice of a stack is bit-equal to the 2-D
call on it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "median_blur_3x3",
    "bilateral_filter",
    "tv_denoise_split_bregman",
]


def _shift2d(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """a shifted so out[..., y, x] = a[..., y+dy, x+dx]; vacated cells = 0."""
    out = torch.zeros_like(a)
    H, W = a.shape[-2:]
    out[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = (
        a[..., max(dy, 0):H - max(-dy, 0), max(dx, 0):W - max(-dx, 0)]
    )
    return out


def _pad_edge(img: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W) -> (..., H + 2r, W + 2r), each slice's edges replicated."""
    H, W = img.shape[-2:]
    padded = F.pad(img.reshape(-1, 1, H, W), (r, r, r, r), mode="replicate")
    return padded.reshape(*img.shape[:-2], H + 2 * r, W + 2 * r)


def median_blur_3x3(img) -> torch.Tensor:
    """3x3 median with edge replication (cv2.medianBlur semantics)."""
    img = torch.as_tensor(img)
    H, W = img.shape
    padded = _pad_edge(img, 1)
    stack = torch.stack(
        [padded[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
        dim=0,
    )
    return torch.sort(stack, dim=0).values[4]


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
    padded = _pad_edge(img, r)

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
