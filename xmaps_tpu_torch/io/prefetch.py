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
``None``.

``stage_compact_group`` stages F whole frames for ``process_frames`` (one
program over the group): ``stage_compact``'s words for each frame as a
row, then the F counts, in ONE host buffer and ONE copy.

The packet-ring prestaging (``PacketRing``, ``RingLayout``,
``assemble_ring_frame[_compact]``) is the port of the JAX package's
default streaming path: every filtered packet is staged as it arrives, so
a frame's events are already on the device when the trigger fires.  Its
bookkeeping (global numbering, slot free list, the 13-bit ``t_rel`` span
split) is the JAX package's line for line.  In place of one
``jax.device_put`` of the whole slot, each staged chunk is ONE
``non_blocking`` copy of its valid words from a pinned host row into its
row of one preallocated device tensor, guarded by a CUDA event as above.
The assembly takes the host ``(3, k)`` placement array and builds the
batch with torch ops; kernel 1's ring entry
(``ops.cuda_events.event_disparity_scatter_ring``) reads the device rows
itself instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from xmaps_tpu_torch.ops.event_batch import EventBatch
from xmaps_tpu_torch.utils.stats import span

__all__ = [
    "HostStagingPool",
    "StagedBatch",
    "unpack_staged",
    "CompactLayout",
    "CompactStagedBatch",
    "CompactStagedGroup",
    "stage_compact_group",
    "fits_layout",
    "unpack_staged_compact",
    "PacketRing",
    "RingPacket",
    "RingLayout",
    "RING_SLOTS_PER_FRAME",
    "assemble_ring_frame",
    "assemble_ring_frame_compact",
    "ring_time_bounds",
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
    """Rotating preallocated host slots for packed EventBatch staging, for
    ``device`` (required, as every entry of the port: no default)."""

    def __init__(
        self,
        capacity: int,
        depth: int = 2,
        *,
        device,
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
        _pack_compact(evs, n, lay, slot.word)
        out = CompactStagedBatch(word=self._ship(slot, "word"), count=n)
        self._copied(slot)
        return out


def _pack_compact(evs: np.ndarray, n: int, lay: CompactLayout, word: np.ndarray) -> None:
    """Pack the first ``n`` events of one frame into the uint32 row
    ``word`` at one word an event (host-binned time), zeroing the rest."""
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


def fits_layout(evs: np.ndarray, layout: CompactLayout) -> bool:
    """Whether every event's x and y fit ``layout``'s widths, as a camera's
    own events do: then a word decodes to the event's own pixel (an event
    outside them would wrap to another)."""
    for name, bits in (("x", layout.bits_x), ("y", layout.bits_y)):
        a = evs[name]
        if len(a) and (int(a.min()) < 0 or int(a.max()) >> bits):
            return False
    return True


class CompactStagedGroup(NamedTuple):
    """F staged frames at one uint32 word an event, in one device buffer."""

    word: torch.Tensor  # (F, capacity) int32 rows, as CompactStagedBatch.word
    counts: torch.Tensor  # (F,) int32 valid lanes of each row, on the device
    host_counts: tuple  # the same F counts on the host


def stage_compact_group(
    frames: list, capacity: int, layout: CompactLayout, *, device
) -> CompactStagedGroup:
    """Stage F complete frames as ``stage_compact`` stages one (the same
    host binning and words, truncation at ``capacity``), into ONE host
    buffer of F rows followed by the F counts, and ONE copy of it to
    ``device`` (pinned and ``non_blocking`` for a CUDA device; PyTorch's
    pinned allocator keeps the buffer until its copy has run)."""
    dev = torch.device(device)
    f = len(frames)
    with span("staging.copy"):  # its pinned buffer
        buf = torch.empty(f * capacity + f, dtype=torch.int32, pin_memory=dev.type == "cuda")
    host = buf.numpy().view(np.uint32)
    counts = [min(len(evs), capacity) for evs in frames]
    with span("staging.pack"):
        for i, (evs, n) in enumerate(zip(frames, counts)):
            _pack_compact(evs, n, layout, host[i * capacity:(i + 1) * capacity])
        host[f * capacity:] = counts
    with span("staging.copy"):  # its enqueue
        out = buf.to(dev, non_blocking=True) if dev.type == "cuda" else buf
    return CompactStagedGroup(
        word=out[:f * capacity].view(f, capacity), counts=out[f * capacity:],
        host_counts=tuple(counts),
    )


# ---------------------------------------------------------------------------
# Packet-ring pre-staging: move the bytes while the frame is still arriving
# ---------------------------------------------------------------------------
#
# The staging above ships a frame's events AFTER the trigger finder has
# segmented it, so the host packing and the H2D copy sit on the critical
# path of the frame's latency.  But the events exist long before the
# trigger fires: packets arrive 4x per frame (delta_t = T/4,
# apps/depth_reprojection.py).  The PacketRing stages every filtered packet
# to the device the moment it arrives; when the trigger finder later emits
# a frame as a GLOBAL event index range [gs, ge), the frame is read from
# the already-resident packet rows, placed by a host (3, k) array.

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


def ring_time_bounds(evs: np.ndarray, capacity: int) -> tuple[int, int]:
    """(min, max) of a non-empty frame's first ``min(len, capacity)``
    timestamps, relative to its first event: the masked min and max of the
    int32 times the assembled batch holds (``t_rel + t_off == t -
    t[0]``).  Kernel 1's ring entry bins time from them, as the 1-word
    staged path bins on the host."""
    t = evs["t"][:capacity]
    t0 = int(evs["t"][0])
    return int(t.min()) - t0, int(t.max()) - t0


class PacketRing:
    """Preallocated pinned host rows + one device tensor of packet rows.

    Slots are reused oldest-first once their packet has been retired
    (every event below the trigger finder's buffer base is final: frames
    are emitted in order and push-back never reaches behind it).  Slot
    count defaults to 4 frames of packets so a slot is never rewritten
    while a frame referencing it is still being dispatched.

    On CUDA each staged chunk is one ``non_blocking`` copy of its ``n``
    valid words from its pinned host row into its device row
    (``rows[name][slot]``), on the current stream.  Two guards:

    - a pinned host row must not be rewritten while its copy is in flight:
      a CUDA event is recorded after each row's copy and waited on before
      the row is refilled;
    - a retired device row is refilled while frame kernels that read it
      may still be queued: this is safe only because the copy and every
      frame kernel that reads the row run on ONE stream, in order.  The
      ring and the engine must use the same (current) stream.

    On CPU the device rows are plain tensors and the copy is synchronous.
    """

    def __init__(
        self,
        packet_capacity: int,
        n_slots: int = 16,
        *,
        device,
        layout: Optional[RingLayout] = None,
    ):
        if n_slots < 2 * RING_SLOTS_PER_FRAME:
            raise ValueError(f"n_slots {n_slots} < 2 * {RING_SLOTS_PER_FRAME}")
        self.packet_capacity = packet_capacity
        self.device = torch.device(device)
        self.layout = layout
        pinned = self.device.type == "cuda"
        names = ("xy",) if layout is not None else ("xy", "tp")
        shape = (n_slots, packet_capacity)
        self._host = {k: torch.zeros(shape, dtype=torch.int32, pin_memory=pinned)
                      for k in names}
        #: the device ring: one int32 row a slot (two tensors for 2 words)
        self.rows = {k: torch.zeros(shape, dtype=torch.int32, device=self.device)
                     for k in names}
        # uint32 / int32 NumPy views of the host rows
        self._xy = self._host["xy"].numpy().view(np.uint32)
        self._tp = self._host["tp"].numpy() if layout is None else None
        self._copied: list[Optional[torch.cuda.Event]] = [None] * n_slots
        self._free = list(range(n_slots))
        self._live: list[RingPacket] = []  # sorted by gbase
        self._next_global = 0
        self.packets_staged = 0
        self.overruns = 0

    def reset(self):
        self._free = list(range(len(self._copied)))
        self._live.clear()
        self._next_global = 0

    def _take(self, slot: int) -> None:
        """Wait until the slot's last copy out of its host row is done."""
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
            self._copied[slot] = None

    def _ship(self, slot: int, n: int) -> None:
        """Copy the slot's ``n`` valid words of each host row to its device
        row, then record the event that guards the host row."""
        cuda = self.device.type == "cuda"
        for name, host in self._host.items():
            self.rows[name][slot, :n].copy_(host[slot, :n], non_blocking=cuda)
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._copied[slot] = ev

    def stage_packets(self, evs: np.ndarray) -> bool:
        """Stage one arrival packet (split into slot-capacity chunks).

        Numbering MUST mirror the trigger finder's: both see the same
        post-filter packet stream.  Returns False (and stages nothing
        more) on ring overrun -- frames touching unstaged ranges fall
        back to segmented staging.
        """
        P = self.packet_capacity
        off = 0
        while off < len(evs):
            end = min(off + P, len(evs))
            if self.layout is not None:
                # bound the chunk's span to the layout's t_rel field
                # (arrival packets are delta_t ~4.2 ms < 2^13 us, so
                # this split only fires on abnormal streams)
                tmax = int(evs["t"][off]) + (1 << self.layout.bits_t) - 1
                if int(evs["t"][end - 1]) > tmax:
                    end = off + int(
                        np.searchsorted(evs["t"][off:end], tmax, "right")
                    )
            chunk = evs[off:end]
            if not self._free:
                self.overruns += 1
                self._next_global += len(evs) - off
                return False
            slot_id = self._free.pop(0)
            self._take(slot_id)
            n = len(chunk)
            t64 = chunk["t"].astype(np.int64, copy=False)
            t_base = int(t64[0])

            if self.layout is not None:
                # ONE packed word/event: x | y << bx | t_rel << (bx+by).
                # Polarity carries no bit -- the upstream polarity filter
                # already dropped p == 0 (RingLayout contract).
                bx, by = self.layout.bits_x, self.layout.bits_y
                w = self._xy[slot_id]
                np.subtract(t64, t_base, out=w[:n], casting="unsafe")
                np.left_shift(w[:n], bx + by, out=w[:n])
                np.bitwise_or(w[:n], chunk["x"].astype(np.uint32), out=w[:n])
                np.bitwise_or(
                    w[:n],
                    chunk["y"].astype(np.uint32) << np.uint32(bx),
                    out=w[:n],
                )
            else:
                xy = self._xy[slot_id]
                np.left_shift(
                    chunk["y"].astype(np.uint32), 16,
                    out=xy[:n], casting="unsafe",
                )
                np.bitwise_or(xy[:n], chunk["x"].astype(np.uint32), out=xy[:n])

                tp = self._tp[slot_id]
                np.subtract(t64, t_base, out=tp[:n], casting="unsafe")
                np.bitwise_or(
                    tp[:n],
                    (chunk["p"].astype(np.int32) & 1) << _P_SHIFT,
                    out=tp[:n],
                )
            # stale lanes beyond n are never addressed (per-packet counts
            # bound every read), so only [:n] crosses to the device
            self._ship(slot_id, n)

            self._live.append(
                RingPacket(
                    xy=self.rows["xy"][slot_id],
                    tp=self.rows["tp"][slot_id] if self.layout is None else None,
                    gbase=self._next_global,
                    count=n,
                    t_base=t_base,
                    slot=slot_id,
                )
            )
            self._next_global += n
            self.packets_staged += 1
            off = end
        return True

    def skip_events(self, num_events: int):
        """Advance the global EVENT numbering past ``num_events`` events
        WITHOUT staging them (used while the watchdog is dropping frames:
        bytes of a doomed frame should never cross the host->device link).
        Frames that later turn out to span a skipped range simply miss
        residency and take the segmented-staging fallback."""
        if num_events < 0:
            raise ValueError(f"skip_events({num_events})")
        self._next_global += num_events

    def retire_below(self, gmin: int):
        """Free slots whose packets end at or before global index gmin."""
        keep = []
        for pkt in self._live:
            if pkt.gbase + pkt.count <= gmin:
                self._free.append(pkt.slot)
            else:
                keep.append(pkt)
        self._live = keep

    def frame_meta(
        self, gs: int, ge: int, frame_t0: int
    ) -> Optional[tuple[list, np.ndarray]]:
        """Packets + (3, K) meta covering global range [gs, ge), or None
        if the range is not fully resident (overrun/reset) or spans more
        than RING_SLOTS_PER_FRAME packets."""
        K = RING_SLOTS_PER_FRAME
        pkts, starts, counts, t_offs = [], [], [], []
        covered = gs
        for pkt in self._live:
            if pkt.gbase + pkt.count <= gs or pkt.gbase >= ge:
                continue
            if pkt.gbase > covered:
                return None  # hole (events were never staged)
            s = max(gs - pkt.gbase, 0)
            e = min(ge - pkt.gbase, pkt.count)
            pkts.append(pkt)
            starts.append(s)
            counts.append(e - s)
            t_offs.append(pkt.t_base - frame_t0)
            covered = pkt.gbase + e
        if covered < ge or not pkts:
            return None
        if len(pkts) > K:
            return None
        # meta is (3, len(pkts)): the frame's actual packet count
        meta = np.stack(
            [
                np.asarray(starts, np.int32),
                np.asarray(counts, np.int32),
                np.asarray(t_offs, np.int32),
            ]
        )
        return pkts, meta

    def frame(
        self, gstart: int, evs: np.ndarray, capacity: int
    ) -> Optional[tuple[list, np.ndarray, tuple[int, int]]]:
        """The arguments of ``XMapsDepthEngine.process_ring`` for the frame
        ``evs`` the trigger finder emitted at global index ``gstart``:
        (packets, (3, k) meta, ``ring_time_bounds`` at ``capacity``), or
        None if the frame is empty or :meth:`frame_meta` finds it not
        (all) resident."""
        if not len(evs):
            return None
        with span("ring.frame"):
            out = self.frame_meta(gstart, gstart + len(evs), int(evs["t"][0]))
            if out is None:
                return None
            return (*out, ring_time_bounds(evs, capacity))
