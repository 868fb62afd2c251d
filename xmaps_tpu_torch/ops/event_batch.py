"""Fixed-capacity SoA event batches (the device-side event representation).

Port of ``xmaps_tpu.ops.event_batch``.  Frames are carried as padded
batches of a static capacity with a validity mask; timestamps are int32
microseconds relative to the frame's first event (a frame spans ~16.7 ms).
The static capacity is kept although PyTorch runs eagerly: a CUDA graph
captured over the frame wants one shape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class EventBatch(NamedTuple):
    """One padded frame of events, SoA layout.

    Attributes:
        x, y: pixel coordinates, int32, shape (capacity,).
        t: microseconds relative to the first event, int32, shape
           (capacity,); or float32 in [0, 1] for the offline eval path.
        p: polarity 0/1, int32, shape (capacity,).
        valid: bool mask, shape (capacity,).
        count: number of valid events, 0-dim int32.

    A group of F frames (``stack_structured``) carries a leading frame
    axis: each field ``(F, capacity)``, ``count`` ``(F,)``.
    """

    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def frame(self, f: int) -> "EventBatch":
        """Frame ``f`` of a stacked group (views of its rows)."""
        return EventBatch(*(a[f] for a in self))

    @staticmethod
    def from_arrays(
        x: np.ndarray,
        y: np.ndarray,
        t: np.ndarray,
        p: np.ndarray,
        capacity: int,
        *,
        device,
    ) -> "EventBatch":
        """Pad/truncate host arrays into a fixed-capacity batch on
        ``device``.  Integer timestamps are rebased to t[0] before narrowing
        to int32; float timestamps stay float32."""
        arrays, n = _host_lanes(x, y, t, p, capacity)

        def dev(a):
            return torch.from_numpy(a).to(device)

        return EventBatch(
            *(dev(a) for a in arrays),
            count=torch.tensor(n, dtype=torch.int32, device=device),
        )

    @staticmethod
    def from_structured(
        evs: np.ndarray, capacity: int, *, device
    ) -> "EventBatch":
        """Build from a Metavision-style structured array with x/y/t/p."""
        return EventBatch.from_arrays(
            evs["x"], evs["y"], evs["t"], evs["p"], capacity, device=device
        )

    @staticmethod
    def stack_structured(
        frames: list, capacity: int, *, device
    ) -> "EventBatch":
        """F frames as one batch with a leading frame axis: each field
        ``(F, capacity)`` (``count`` ``(F,)``), row f equal to
        ``from_structured(frames[f], capacity)``, each field built on the
        host and copied to ``device`` once.  The frames' timestamps must
        be all integer or all float."""
        lanes = [_host_lanes(ev["x"], ev["y"], ev["t"], ev["p"], capacity) for ev in frames]
        if len({arrays[2].dtype for arrays, _ in lanes}) > 1:
            raise ValueError("stack_structured: integer and float timestamps in one group")

        def dev(rows):
            return torch.from_numpy(np.stack(rows)).to(device)

        return EventBatch(
            *(dev(rows) for rows in zip(*(arrays for arrays, _ in lanes))),
            count=dev([np.int32(n) for _, n in lanes]),
        )


def _host_lanes(x, y, t, p, capacity: int):
    """The host arrays (x, y, t, p, valid) of one padded batch, and its
    count."""
    n = min(len(x), capacity)

    def pad(a, dtype):
        out = np.zeros(capacity, dtype=dtype)
        out[:n] = np.asarray(a)[:n]
        return out

    if np.issubdtype(np.asarray(t).dtype, np.integer):
        t_rel = np.asarray(t[:n], dtype=np.int64)
        if n:
            t_rel = t_rel - t_rel[0]
        t_arr = pad(t_rel, np.int32)
    else:
        t_arr = pad(np.asarray(t[:n], dtype=np.float32), np.float32)

    valid = np.zeros(capacity, dtype=bool)
    valid[:n] = True
    return (pad(x, np.int32), pad(y, np.int32), t_arr, pad(p, np.int32), valid), n
