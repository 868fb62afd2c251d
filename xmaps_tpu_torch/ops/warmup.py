"""Kernel W wrapper: ``warmup_add_one``, the engine benchmark's warm-up.

``warmup_add_one(x)`` returns ``x + 1`` for an int32 tensor.  On a CUDA
tensor it launches ``csrc/warmup.cu`` (replacing the TPU kernel ``_noop``,
``bench.py:93-103``); on a CPU tensor it runs the plain version,
``warmup_add_one_plain``.
"""

from __future__ import annotations

import torch

from xmaps_tpu_torch.ops import _build

__all__ = ["WARMUP_SHAPE", "warmup_add_one", "warmup_add_one_plain"]

#: the TPU kernel's tile: (8, 128) int32
WARMUP_SHAPE = (8, 128)


def warmup_add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``warmup_add_one`` (any device)."""
    return x + 1


def warmup_add_one(x: torch.Tensor) -> torch.Tensor:
    """int32 ``x`` -> ``x + 1`` (a new tensor of x's shape)."""
    dev = x.device
    if dev.type == "cpu":
        return warmup_add_one_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"warmup_add_one: unsupported device {dev}")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(
            f"warmup_add_one: x must be a contiguous int32 tensor, got {x.dtype}"
        )
    out = torch.empty_like(x)
    _build.launch(
        dev, "warmup_add_one", "warmup_add_one",
        x.data_ptr(), out.data_ptr(), x.numel(),
    )
    return out
