"""Double-buffered host -> device staging of event batches.

Port of the segmented staging of ``xmaps_tpu.io.prefetch`` (``StagedBatch``,
``CompactLayout``, ``CompactStagedBatch``, ``HostStagingPool.stage`` /
``stage_compact`` and the device-side unpacks).  The reference recycles
native event buffers through a free list (event_buf_pool.py:10-17) so the
per-packet hot path never allocates; here:

- ``HostStagingPool`` owns ``depth`` preallocated packed host slots at the
  pipeline's fixed capacity and fills them in place per frame;
- events cross to the device as TWO words per event (``xy = x | y << 16``
  and ``tp = t_rel | p << 30``) or, with a ``CompactLayout``, as ONE word
  (``x | y << bits_x | t_bin << (bits_x + bits_y)``, the X-map time bin
  computed exactly on the host).  The validity mask is implied by the
  count, which stays on the host: the unpack builds it on the device;
- on CUDA the slots are pinned host tensors, and each staged array is ONE
  ``non_blocking`` copy on the current stream (the engine path it replaces
  made five pageable copies, each synchronising the host);
- a pinned slot must not be refilled while its copy is in flight: a CUDA
  event is recorded after each slot's copy and waited on before the slot
  is written again.  (The JAX package's ``device_put`` gave this for free.)

On CPU the slots are plain host tensors and the "copy" is a clone.  The
host target presort (``presort_fn``) is not ported: the JAX pipe passes
``None``.  The ``PacketRing`` prestaging is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from xmaps_tpu_torch.ops.event_batch import EventBatch

__all__ = [
    "HostStagingPool",
    "StagedBatch",
    "unpack_staged",
    "CompactLayout",
    "CompactStagedBatch",
    "unpack_staged_compact",
]

#: polarity rides in bit 30 of the int32 tp word; frame-relative
#: microsecond timestamps are far below 2**30 (~17.9 min).
_P_SHIFT = 30
_T_MASK = (1 << _P_SHIFT) - 1


class StagedBatch(NamedTuple):
    """One staged frame: packed device arrays + host count."""

    xy: torch.Tensor  # (capacity,) int32 holding the uint32 x | y << 16
    tp: torch.Tensor  # (capacity,) int32: t_rel | p << 30
    count: int  # valid lanes [0, count)


def _lanes_valid(n: int, count: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(valid mask, 0-dim int32 count) built on ``device`` from a host
    count, with no host -> device copy."""
    valid = torch.arange(n, dtype=torch.int32, device=device) < count
    return valid, torch.full((), count, dtype=torch.int32, device=device)


def unpack_staged(staged: StagedBatch) -> EventBatch:
    """Unpack to the standard EventBatch on the staged arrays' device."""
    xy = staged.xy
    valid, count = _lanes_valid(xy.shape[0], staged.count, xy.device)
    return EventBatch(
        x=xy & 0xFFFF,
        y=(xy >> 16) & 0xFFFF,
        t=staged.tp & _T_MASK,
        p=staged.tp >> _P_SHIFT,
        valid=valid,
        count=count,
    )


class CompactLayout(NamedTuple):
    """Bit layout for ONE-word-per-event staging.

    The X-map lookup only ever sees the event's time as a discretized
    bin in [0, t_px_scale] (time axis = projector columns,
    ops/disparity.py), so the host can compute the bin exactly -- the
    same integer round-half-to-even as the device -- and ship
    ``t_scaled`` instead of a raw timestamp.  With the coordinates that
    fits one uint32 per event (word = x | y << bits_x | t_scaled <<
    (bits_x + bits_y)), halving host->device bytes vs the 2-word
    staging.  Polarity is not carried: the host polarity filter runs
    before staging, and nothing on device reads p (the frame dedup
    filters, the only consumers, force the 2-word path -- they must
    re-bin time after dropping events).
    """

    bits_x: int
    bits_y: int
    bits_t: int
    t_px_scale: int

    @staticmethod
    def for_pipeline(cfg) -> Optional["CompactLayout"]:
        """Layout for a PipelineConfig, or None if 32 bits don't fit
        (very large sensor / time axis) -- callers use 2-word staging."""
        bits_x = max(int(cfg.camera_width - 1).bit_length(), 1)
        bits_y = max(int(cfg.camera_height - 1).bit_length(), 1)
        bits_t = max(int(cfg.t_px_scale).bit_length(), 1)
        if bits_x + bits_y + bits_t > 32:
            return None
        return CompactLayout(bits_x, bits_y, bits_t, int(cfg.t_px_scale))


class CompactStagedBatch(NamedTuple):
    """One staged frame at one uint32 word per event."""

    word: torch.Tensor  # (capacity,) int32 holding x | y << bx | ts << (bx+by)
    count: int  # valid lanes [0, count)


def unpack_staged_compact(
    staged: CompactStagedBatch, layout: CompactLayout
) -> tuple[EventBatch, torch.Tensor]:
    """Unpack to (EventBatch, t_scaled).

    The returned batch carries p=1 (host polarity filter ran before
    staging) and t = t_scaled (only the bins exist at this point).  This
    is the plain version of kernel 1's staged entry
    (``ops.cuda_events.event_disparity_scatter_staged``), which decodes the
    words in registers on the card.
    """
    w = staged.word
    valid, count = _lanes_valid(w.shape[0], staged.count, w.device)
    x = w & ((1 << layout.bits_x) - 1)
    y = (w >> layout.bits_x) & ((1 << layout.bits_y) - 1)
    ts = (w >> (layout.bits_x + layout.bits_y)) & ((1 << layout.bits_t) - 1)
    batch = EventBatch(x=x, y=y, t=ts, p=torch.ones_like(x), valid=valid, count=count)
    return batch, ts


def _scale_time_int_host(t: np.ndarray, t_px_scale: int) -> np.ndarray:
    """Host mirror of ops.disparity._scale_time_int (exact integer
    round-half-to-even of (t - min) * scale / (max - min)), in int64."""
    t = np.asarray(t, dtype=np.int64)
    if len(t) == 0:
        return t.astype(np.int32)
    t_min = t.min()
    rng = max(int(t.max()) - int(t_min), 1)
    num = (t - t_min) * np.int64(t_px_scale)
    q, r = np.divmod(num, rng)
    twice = 2 * r
    round_up = (twice > rng) | ((twice == rng) & (q % 2 == 1))
    return (q + round_up).astype(np.int32)


class _Slot:
    """One host staging slot: int32 host tensors (pinned for a CUDA
    target), uint32/int32 NumPy views of them, and the CUDA event of the
    last copy out of the slot."""

    def __init__(self, capacity: int, pinned: bool):
        def host():
            return torch.zeros(capacity, dtype=torch.int32, pin_memory=pinned)

        self.tensors = {"xy": host(), "tp": host(), "word": host()}
        self.xy = self.tensors["xy"].numpy().view(np.uint32)
        self.tp = self.tensors["tp"].numpy()
        self.word = self.tensors["word"].numpy().view(np.uint32)
        self.copied: Optional[torch.cuda.Event] = None


class HostStagingPool:
    """Rotating preallocated host slots for packed EventBatch staging."""

    def __init__(
        self,
        capacity: int,
        depth: int = 2,
        device="cpu",
        layout: Optional[CompactLayout] = None,
    ):
        if depth < 2:
            raise ValueError("need >= 2 slots to overlap H2D with compute")
        self.capacity = capacity
        self.device = torch.device(device)
        self.layout = layout
        pinned = self.device.type == "cuda"
        self._slots = [_Slot(capacity, pinned) for _ in range(depth)]
        self._next = 0
        self.frames_staged = 0
        self.events_truncated = 0

    def _take_slot(self, n_events: int) -> tuple[_Slot, int]:
        """The next slot, once its previous copy has finished, and the
        number of events that fit."""
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot.copied is not None:
            slot.copied.synchronize()
            slot.copied = None
        n = min(n_events, self.capacity)
        self.events_truncated += n_events - n
        self.frames_staged += 1
        return slot, n

    def _ship(self, slot: _Slot, name: str) -> torch.Tensor:
        """One copy of a slot array to the device (a clone on CPU)."""
        src = slot.tensors[name]
        if self.device.type == "cpu":
            return src.clone()
        return src.to(self.device, non_blocking=True)

    def _copied(self, slot: _Slot) -> None:
        """Record the event that guards the slot's copies."""
        if self.device.type == "cuda":
            slot.copied = torch.cuda.Event()
            slot.copied.record(torch.cuda.current_stream(self.device))

    def stage(self, evs: np.ndarray) -> StagedBatch:
        """Fill the next host slot in place and start the H2D copies.

        Semantics match EventBatch.from_structured (rebased int32
        timestamps, zero padding, truncation at capacity).
        """
        slot, n = self._take_slot(len(evs))
        xy = slot.xy
        np.left_shift(
            evs["y"][:n].astype(np.uint32), 16, out=xy[:n], casting="unsafe"
        )
        np.bitwise_or(xy[:n], evs["x"][:n].astype(np.uint32), out=xy[:n])
        xy[n:] = 0

        tp = slot.tp
        if n:
            t64 = evs["t"][:n].astype(np.int64, copy=False)
            np.subtract(t64, t64[0], out=tp[:n], casting="unsafe")
            np.bitwise_or(
                tp[:n],
                (evs["p"][:n].astype(np.int32) & 1) << _P_SHIFT,
                out=tp[:n],
            )
        tp[n:] = 0

        out = StagedBatch(xy=self._ship(slot, "xy"), tp=self._ship(slot, "tp"), count=n)
        self._copied(slot)
        return out

    def stage_compact(self, evs: np.ndarray) -> CompactStagedBatch:
        """Fill the next host slot at ONE uint32 word per event and start
        the H2D copy.  Requires a CompactLayout (pool init) and a
        complete frame slice (time bins need the frame's min/max t).
        Bit-identical downstream results to :meth:`stage` for
        frame_filter == "none" pipelines."""
        lay = self.layout
        if lay is None:
            raise ValueError("HostStagingPool built without a layout")
        slot, n = self._take_slot(len(evs))
        word = slot.word
        if n:
            ts = _scale_time_int_host(evs["t"][:n], lay.t_px_scale)
            np.left_shift(
                ts.astype(np.uint32),
                lay.bits_x + lay.bits_y,
                out=word[:n],
                casting="unsafe",
            )
            np.bitwise_or(
                word[:n],
                evs["y"][:n].astype(np.uint32) << lay.bits_x,
                out=word[:n],
            )
            np.bitwise_or(word[:n], evs["x"][:n].astype(np.uint32), out=word[:n])
        word[n:] = 0

        out = CompactStagedBatch(word=self._ship(slot, "word"), count=n)
        self._copied(slot)
        return out
