"""Double-buffered host -> device staging of event batches.

The host half of ``xmaps_tpu.io.prefetch``, ported: the pools and packers
that write a frame's events as the staged formats, and the packet ring.
The formats themselves and their device decoders are ``ops.staged`` (the
format half of the JAX module).  The reference recycles native event
buffers through a free list (event_buf_pool.py:10-17) so the per-packet hot
path never allocates; here:

- ``HostStagingPool`` owns ``depth`` preallocated packed host slots at the
  pipeline's fixed capacity and fills them in place per frame, at TWO words
  an event (``stage``: a ``StagedBatch``) or, with a ``CompactLayout``, at
  ONE (``stage_compact``: a ``CompactStagedBatch``, the time bin computed
  exactly on the host);
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
row, then the F counts, in ONE host buffer and ONE copy.  ``scan_group``
checks the group for it.  Frames that are runs of the decoder's
``EVENT_DTYPE`` records are scanned and packed by one native call a group
(``io.stage_pack``) straight into the pinned buffer; any other frame by
the NumPy code (``fits_layout``, ``_pack_compact_numpy``), which is the
native entries' plain version.

The packet-ring prestaging (``PacketRing``) is the port of the JAX
package's default streaming path: every filtered packet is staged as it
arrives, so a frame's events are already on the device when the trigger
fires.  Its bookkeeping (global numbering, slot free list, the 13-bit
``t_rel`` span split) is the JAX package's line for line.  In place of one
``jax.device_put`` of the whole slot, each staged chunk is ONE
``non_blocking`` copy of its valid words from a pinned host row into its
row of one preallocated device tensor, guarded by a CUDA event as above.
``ops.staged.assemble_ring_frame[_compact]`` builds the batch from the
rows with torch ops; kernel 1's ring entry
(``ops.cuda_events.event_disparity_scatter_ring``) reads the device rows
itself instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from xmaps_tpu_torch.io import stage_pack
from xmaps_tpu_torch.ops.staged import (
    _P_SHIFT,
    RING_SLOTS_PER_FRAME,
    CompactLayout,
    CompactStagedBatch,
    CompactStagedGroup,
    RingLayout,
    RingPacket,
    StagedBatch,
)
from xmaps_tpu_torch.utils.stats import span

__all__ = ["HostStagingPool", "GroupScan", "scan_group", "stage_compact_group", "fits_layout",
           "PacketRing", "ring_time_bounds"]


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
    ``word`` at one word an event (host-binned time), zeroing the rest:
    natively where ``scan_group`` routes the frame so, else in NumPy."""
    if not stage_pack.native_fields(evs):
        _pack_compact_numpy(evs, n, lay, word)
        return
    head = evs[:n]  # the scan then reads the staged events alone (the fit is not asked)
    _pack_rows([head], [n], lay, [word], scan_group([head], lay, n))


def _pack_compact_numpy(evs: np.ndarray, n: int, lay: CompactLayout, word: np.ndarray) -> None:
    """The plain version of the native pack (``io.stage_pack.pack``), for
    one frame."""
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
    outside them would wrap to another).  The plain version of the native
    scan's check (``io.stage_pack.scan``)."""
    for name, bits in (("x", layout.bits_x), ("y", layout.bits_y)):
        a = evs[name]
        if len(a) and (int(a.min()) < 0 or int(a.max()) >> bits):
            return False
    return True


class GroupScan(NamedTuple):
    """A group's check for 1-word staging (``scan_group``), valid while its
    frames are unchanged."""

    frames: tuple  # the frames it was made over
    capacity: int  # the capacity it was made at
    fits: bool  # every event's x and y fit the layout
    native: tuple  # per frame: whether the native pack stages it
    read: tuple  # the frames the native scan read (``stage_pack.native_fields``)
    addresses: np.ndarray  # (2, len(read)) their ``stage_pack.addresses``
    t_lo: np.ndarray  # (len(read),) int64 min t of their staged events
    t_hi: np.ndarray  # (len(read),) int64 their max t


def scan_group(frames: list, layout: CompactLayout, capacity: int) -> GroupScan:
    """Check F frames for 1-word staging at ``capacity``: whether every
    event's pixel fits ``layout`` (over all of a frame's events, as
    ``fits_layout``), and which frames the native pack stages.  That is a
    frame the native scan can read (``stage_pack.native_fields``) whose time
    range over its first ``min(len, capacity)`` events, times the layout's
    scale, is below ``stage_pack.MAX_SPAN``; the scan gives that range."""
    read = tuple(i for i, ev in enumerate(frames) if stage_pack.native_fields(ev))
    addresses = stage_pack.addresses([frames[i] for i in read])
    fits, lo, hi = True, np.zeros(0, np.int64), np.zeros(0, np.int64)
    if read:
        fits, lo, hi = stage_pack.scan(addresses, capacity, layout.bits_x, layout.bits_y)
    fits = fits and all(fits_layout(ev, layout) for i, ev in enumerate(frames) if i not in read)
    native = [False] * len(frames)
    for i, a, b in zip(read, lo.tolist(), hi.tolist()):
        native[i] = max(b - a, 1) * layout.t_px_scale < stage_pack.MAX_SPAN
    return GroupScan(tuple(frames), capacity, fits, tuple(native), read, addresses, lo, hi)


def _pack_rows(frames: list, counts: list, lay: CompactLayout, rows: list,
               scan: GroupScan) -> None:
    """Pack each frame's first ``counts[i]`` events into the uint32 row
    ``rows[i]``: one native call for the frames ``scan`` routes so, the
    NumPy pack for the others."""
    sel = [j for j, i in enumerate(scan.read) if scan.native[i]]
    if sel:
        idx = [scan.read[j] for j in sel]
        stage_pack.pack(scan.addresses[:, sel], [rows[i] for i in idx], [counts[i] for i in idx],
                        len(rows[0]), lay.bits_x, lay.bits_y, lay.t_px_scale,
                        scan.t_lo[sel], scan.t_hi[sel])
    for i, k in enumerate(scan.native):
        if not k:
            _pack_compact_numpy(frames[i], counts[i], lay, rows[i])



def stage_compact_group(
    frames: list, capacity: int, layout: CompactLayout, *, device,
    scan: Optional[GroupScan] = None,
) -> CompactStagedGroup:
    """Stage F complete frames as ``stage_compact`` stages one (the same
    host binning and words, truncation at ``capacity``), into ONE host
    buffer of F rows followed by the F counts, and ONE copy of it to
    ``device`` (pinned and ``non_blocking`` for a CUDA device; PyTorch's
    pinned allocator keeps the buffer until its copy has run).  ``scan``:
    the group's ``scan_group`` at ``capacity``, where the caller made it
    (else it is made here); a scan made at another capacity or over other
    frame arrays raises ``ValueError``.
    The ``staging.pack`` span's tag is the route the pack takes: "native"
    where every frame takes the native pack, else "numpy"."""
    dev = torch.device(device)
    f = len(frames)
    if scan is None:
        with span("staging.check"):
            scan = scan_group(frames, layout, capacity)
    elif (scan.capacity != capacity or len(scan.frames) != f
          or any(a is not b for a, b in zip(scan.frames, frames))):
        raise ValueError("the scan was made at another capacity or over other frames")
    with span("staging.copy"):  # its pinned buffer
        buf = torch.empty(f * capacity + f, dtype=torch.int32, pin_memory=dev.type == "cuda")
    host = buf.numpy().view(np.uint32)
    counts = [min(len(evs), capacity) for evs in frames]
    with span("staging.pack", "native" if all(scan.native) else "numpy"):
        _pack_rows(frames, counts, layout,
                   [host[i * capacity:(i + 1) * capacity] for i in range(f)], scan)
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
