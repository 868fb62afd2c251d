"""The staged event formats and their device decoders.

The format half of ``xmaps_tpu.io.prefetch``, ported; the host half (the
pools and packers that write these words, and the packet ring) is
``io.prefetch``.  The decoders are torch ops on the words' device, the
plain versions of kernel 1's staged and ring entries (``ops.cuda_events``),
which read the same words in registers.  A frame's validity mask is implied
by its count, which stays on the host.

- ``StagedBatch``: TWO words an event, ``x | y << 16`` and ``t_rel | p <<
  30`` (``unpack_staged``).
- ``CompactStagedBatch``: ONE word an event under a ``CompactLayout``, ``x
  | y << bits_x | t_bin << (bits_x + bits_y)``, the X-map time bin binned
  on the host (``unpack_staged_compact``); ``CompactStagedGroup``: F such
  frames as the rows of one device buffer.
- ``RingPacket``: a packet resident in a ring row, at two words or at one
  under a ``RingLayout`` (``x | y << bits_x | t_rel << (bits_x + bits_y)``);
  ``assemble_ring_frame[_compact]`` builds a frame of up to
  ``RING_SLOTS_PER_FRAME`` of them from the host ``(3, k)`` placement.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from xmaps_tpu_torch.ops.event_batch import EventBatch

__all__ = ["StagedBatch", "unpack_staged", "CompactLayout", "CompactStagedBatch",
           "unpack_staged_compact", "CompactStagedGroup", "RING_SLOTS_PER_FRAME", "RingLayout",
           "RingPacket", "assemble_ring_frame", "assemble_ring_frame_compact"]

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



class CompactStagedGroup(NamedTuple):
    """F staged frames at one uint32 word an event, in one device buffer."""

    word: torch.Tensor  # (F, capacity) int32 rows, as CompactStagedBatch.word
    counts: torch.Tensor  # (F,) int32 valid lanes of each row, on the device
    host_counts: tuple  # the same F counts on the host


# -- the packet ring's formats: a frame read from packet rows already on the
# device (``io.prefetch.PacketRing``), placed by a host (3, k) array

#: max packets assembled into one frame (4/frame nominal + trigger slack;
#: packets longer than the slot capacity are split at staging)
RING_SLOTS_PER_FRAME = 8


class RingLayout(NamedTuple):
    """ONE-word-per-event ring staging: ``x | y << bits_x |
    t_rel << (bits_x + bits_y)``.

    Valid when (a) the polarity filter runs upstream of staging (the pipe's
    fused polarity+activity filter guarantees every staged event has
    p == 1, so polarity needs no bit) and (b) the camera dims leave >= 13
    bits for the packet-relative time (arrival packets span delta_t ~4.2
    ms < 8.2 ms; longer spans are split at stage time).  640x480 sensors
    fit exactly (10 + 9 + 13 = 32, so bit 31 is set for t_rel >= 4096);
    larger sensors use 2-word staging."""

    bits_x: int
    bits_y: int
    bits_t: int

    @staticmethod
    def for_camera(width: int, height: int) -> Optional["RingLayout"]:
        bx = max(int(np.ceil(np.log2(max(width, 2)))), 1)
        by = max(int(np.ceil(np.log2(max(height, 2)))), 1)
        bt = 32 - bx - by
        if bt < 13:
            return None
        return RingLayout(bx, by, bt)


class RingPacket(NamedTuple):
    """One staged packet: its device rows + host-side placement metadata."""

    xy: torch.Tensor  # (packet_capacity,) int32 device row: the uint32
    #   x | y << 16, or the single packed word when the ring uses a
    #   RingLayout; lanes [0, count) are this packet's
    tp: Optional[torch.Tensor]  # (packet_capacity,) int32: t_rel | p << 30;
    #   None in compact (RingLayout) mode
    gbase: int  # global index of this packet's first event
    count: int  # valid events in the slot
    t_base: int  # absolute microsecond timestamp of the first event
    slot: int  # host slot index (ring bookkeeping)


def _ring_segments(rows, meta: np.ndarray, capacity: int) -> list:
    """Each packet's lanes of the frame, in arrival order, as views of its
    device row: ``row[start : start + count]``, the total cut at
    ``capacity`` (a larger frame keeps its first ``capacity`` events, as
    ``EventBatch.from_structured`` does)."""
    segs, left = [], capacity
    for row, start, count in zip(rows, meta[0], meta[1]):
        n = min(int(count), left)
        segs.append(row[int(start):int(start) + n])
        left -= n
    return segs


def _ring_batch(x, y, t, p, capacity: int) -> EventBatch:
    """The batch of the frame's lanes ``x, y, t, p`` (one tensor each),
    zero-padded to ``capacity`` as the segmented staging pads."""
    n = x.shape[0]
    valid, count = _lanes_valid(capacity, n, x.device)

    def pad(a):
        return torch.nn.functional.pad(a, (0, capacity - n))

    return EventBatch(x=pad(x), y=pad(y), t=pad(t), p=pad(p), valid=valid, count=count)


def assemble_ring_frame(xys, tps, meta: np.ndarray, capacity: int) -> EventBatch:
    """Frame assembly from k resident packet rows (2-word ring).

    ``meta`` is the host (3, k) int32 array of ``PacketRing.frame_meta``:
    row 0 = per-packet start lane, row 1 = per-packet event count, row 2 =
    per-packet time offset (packet t_base minus the frame's first event
    time).  Packet k's events land contiguously after those of the packets
    before it, giving the same contiguous, arrival-ordered,
    capacity-padded batch (and bit-identical timestamps) as
    ``EventBatch.from_structured`` of the segmented frame.  Torch ops on
    the rows' device, from the host counts: no host -> device copy.
    """
    sx = _ring_segments(xys, meta, capacity)
    st = _ring_segments(tps, meta, capacity)
    xy = torch.cat(sx)
    tp = torch.cat(st)
    t = torch.cat([(s & _T_MASK) + int(off) for s, off in zip(st, meta[2])])
    return _ring_batch(xy & 0xFFFF, (xy >> 16) & 0xFFFF, t, tp >> _P_SHIFT, capacity)


def assemble_ring_frame_compact(
    ws, meta: np.ndarray, capacity: int, layout: RingLayout
) -> EventBatch:
    """:func:`assemble_ring_frame` for compact (one-word) ring packets.

    Same placement, one segment stream instead of two, and p
    reconstructed as the constant 1 the upstream polarity filter
    guarantees.  Bit-identical to ``EventBatch.from_structured`` of the
    segmented slice.  This is also the first step of the plain version of
    kernel 1's ring entry, which decodes the rows in registers on the
    card."""
    bx, by = layout.bits_x, layout.bits_y
    shift = bx + by
    segs = _ring_segments(ws, meta, capacity)
    word = torch.cat(segs)
    # logical shift: the word is packed unsigned (u32 reinterpreted)
    t_mask = (1 << (32 - shift)) - 1
    t = torch.cat([((s >> shift) & t_mask) + int(off) for s, off in zip(segs, meta[2])])
    x = word & ((1 << bx) - 1)
    return _ring_batch(x, (word >> bx) & ((1 << by) - 1), t, torch.ones_like(x), capacity)

