"""Kernel S wrapper: ``tile_store_last``, the scatter-store micro-benchmark.

``tile_store_last(rows, cols, vals, shape)`` zeroes an (H, W) uint32 tile
and stores ``vals[j]`` at ``(rows[j], cols[j])`` for j = 0..N-1 in order:
the last write to a cell wins, and events outside the tile are dropped.
uint32 is held as the int32 bit pattern (as ``ops.scatter`` does): ``vals``
and the tile are int32 tensors.  On a CUDA tensor it launches
``csrc/store_loop.cu`` (replacing the TPU kernel ``kernel_rowcol``,
``eval/bench_store_loop.py:52-83``), one launch of thread-block clusters
that hold the tile in distributed shared memory; on a CPU tensor it runs
the plain version, ``tile_store_last_plain``.
"""

from __future__ import annotations

import torch

from xmaps_tpu_torch.ops import _build

__all__ = [
    "BENCH_SHAPE",
    "BENCH_EVENTS",
    "tile_store_last",
    "tile_store_last_plain",
]

#: the TPU benchmark's tile (one tail band of the ESL crop) and event count
BENCH_SHAPE = (64, 1152)
BENCH_EVENTS = 28 * 1024


def tile_store_last_plain(
    rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, shape: tuple[int, int]
) -> torch.Tensor:
    """Plain PyTorch version of ``tile_store_last`` (any device): a
    scatter-max of ``j + 1`` per cell, then a gather of ``vals``."""
    H, W = shape
    n = rows.shape[0]
    ok = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    # dropped events go to one extra cell past the tile
    cell = torch.where(ok, rows.long() * W + cols.long(), H * W)
    winner = torch.zeros(H * W + 1, dtype=torch.int64, device=rows.device)
    order = torch.arange(1, n + 1, dtype=torch.int64, device=rows.device)
    winner.scatter_reduce_(0, cell, order, reduce="amax")
    # winner 0 (no event) gathers the 0 put in front of the values
    padded = torch.cat([vals.new_zeros(1), vals])
    return padded[winner[: H * W]].view(H, W)


def tile_store_last(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    shape: tuple[int, int],
) -> torch.Tensor:
    """(N,) int32 rows and cols, (N,) int32 vals (uint32 bits) -> the (H, W)
    int32 tile of the last value stored in each cell (0 where none)."""
    dev = rows.device
    if dev.type == "cpu":
        return tile_store_last_plain(rows, cols, vals, shape)
    if dev.type != "cuda":
        raise ValueError(f"tile_store_last: unsupported device {dev}")
    n = rows.shape[0]
    for name, a in (("rows", rows), ("cols", cols), ("vals", vals)):
        if (a.device != dev or a.dtype != torch.int32 or a.shape != (n,)
                or not a.is_contiguous()):
            raise ValueError(
                f"tile_store_last: {name} must be a contiguous ({n},) int32 tensor "
                f"on {dev}, got {tuple(a.shape)} {a.dtype} on {a.device}"
            )
    H, W = shape
    out = torch.empty((H, W), dtype=torch.int32, device=dev)
    _build.launch(
        dev, "tile_store_last", "tile_store_last",
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), n, H, W, out.data_ptr(),
    )
    return out
