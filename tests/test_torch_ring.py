"""The port's packet-ring prestaging vs the JAX package's, on the CPU.

``xmaps_tpu_torch.io.prefetch``'s ``PacketRing``, ``ops.staged``'s
``RingLayout`` and ring assembly, kernel 1's ring entry (its plain version on CPU tensors) and the
engine's ``process_ring`` against ``xmaps_tpu``: the same packet streams,
made from numpy seeds, go through both packages.  Every comparison is
bit-exact.  The first six tests are ports of the JAX package's ring tests
(tests/test_prefetch.py), held against the JAX ``EventBatch``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from xmaps_tpu.io.evt_decoder import EVENT_DTYPE  # noqa: E402
from xmaps_tpu.io.prefetch import PacketRing as JRing  # noqa: E402
from xmaps_tpu.io.prefetch import RingLayout as JLayout  # noqa: E402
from xmaps_tpu.io.prefetch import assemble_ring_frame as j_assemble  # noqa: E402
from xmaps_tpu.io.prefetch import assemble_ring_frame_compact as j_assemble_compact  # noqa: E402
from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.ops import disparity as jdisp  # noqa: E402
from xmaps_tpu.ops.event_batch import EventBatch as JBatch  # noqa: E402
from xmaps_tpu.ops.scatter import scatter_disp_packed as j_scatter  # noqa: E402
from xmaps_tpu.utils.synthetic import make_synthetic_calibration as j_calib  # noqa: E402
from xmaps_tpu.utils.synthetic import simulate_plane_events  # noqa: E402

from xmaps_tpu_torch.io.prefetch import PacketRing, ring_time_bounds  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine  # noqa: E402
from xmaps_tpu_torch.ops.cuda_events import (  # noqa: E402
    event_disparity_scatter_ring,
    event_disparity_scatter_ring_plain,
)
from xmaps_tpu_torch.ops.event_batch import EventBatch  # noqa: E402
from xmaps_tpu_torch.ops.frame_pipeline import DeviceTables  # noqa: E402
from xmaps_tpu_torch.ops.staged import (  # noqa: E402
    RING_SLOTS_PER_FRAME,
    RingLayout,
    assemble_ring_frame,
    assemble_ring_frame_compact,
)
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration  # noqa: E402

torch.set_num_threads(1)

OFFS = [0, 700, 1500, 2100, 3000, 3900, 4400, 5000]
RANGES = [(950, 4200), (0, 700), (702, 800), (100, 4390)]


def _ring_events(rng, n, t0=5_000_000, span=50_000):
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    ev["x"] = rng.integers(0, 640, n)
    ev["y"] = rng.integers(0, 480, n)
    ev["p"] = rng.integers(0, 2, n)
    ev["t"] = t0 + np.sort(rng.integers(0, span, n))
    return ev


def _assert_batch(got: EventBatch, want, what=""):
    """A port batch against a JAX (or port) batch, every field."""
    for f in EventBatch._fields:
        a, b = getattr(got, f), getattr(want, f)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.array(b)
        assert a.dtype == torch.from_numpy(b).dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{f} differs {what}")


def _rows(pkts):
    return tuple(p.xy for p in pkts), tuple(p.tp for p in pkts)


# -- ports of tests/test_prefetch.py's six ring tests ------------------------

def test_ring_assembly_bit_identical():
    """A frame assembled from pre-staged packet rows equals the JAX
    EventBatch.from_structured of the segmented slice, bit for bit --
    including packet splitting, mid-packet frame boundaries and padding."""
    ev = _ring_events(np.random.default_rng(0), 5000)
    ring = PacketRing(packet_capacity=800, n_slots=16, device="cpu")
    for a, b in zip(OFFS[:-1], OFFS[1:]):
        assert ring.stage_packets(ev[a:b])
    cap = 4096
    for gs, ge in RANGES:
        frame = ev[gs:ge]
        out = ring.frame_meta(gs, ge, int(frame["t"][0]))
        assert out is not None, (gs, ge)
        pkts, meta = out
        assert meta.shape == (3, len(pkts)) and len(pkts) <= RING_SLOTS_PER_FRAME
        got = assemble_ring_frame(*_rows(pkts), meta, cap)
        _assert_batch(got, JBatch.from_structured(frame, cap), f"for [{gs}, {ge})")


def test_ring_assembly_compact_bit_identical():
    """Compact (one-word RingLayout) ring staging assembles the JAX
    EventBatch.from_structured of the segmented slice, p reconstructed as
    the 1 the upstream polarity filter guarantees; the words fill 32 bits
    (t_rel >= 4096 sets bit 31 at 640 x 480)."""
    layout = RingLayout.for_camera(640, 480)
    assert layout == (10, 9, 13)
    ev = _ring_events(np.random.default_rng(1), 5000)
    ev["p"] = 1
    ring = PacketRing(packet_capacity=800, n_slots=16, device="cpu", layout=layout)
    for a, b in zip(OFFS[:-1], OFFS[1:]):
        assert ring.stage_packets(ev[a:b])
    assert (ring.rows["xy"].numpy().view(np.uint32) >> 31).any()
    cap = 4096
    for gs, ge in RANGES:
        frame = ev[gs:ge]
        pkts, meta = ring.frame_meta(gs, ge, int(frame["t"][0]))
        assert all(p.tp is None for p in pkts)
        got = assemble_ring_frame_compact(_rows(pkts)[0], meta, cap, layout)
        _assert_batch(got, JBatch.from_structured(frame, cap), f"for [{gs}, {ge})")


def test_ring_compact_splits_long_spans():
    """A staged chunk spanning more than 2^bits_t us splits so every
    packet's t_rel fits the layout's field -- and still assembles exactly."""
    layout = RingLayout.for_camera(640, 480)
    rng = np.random.default_rng(2)
    n = 3000
    ev = _ring_events(rng, n, t0=1_000_000, span=20_000)  # > 2x the 8.192 ms field
    ev["p"] = 1
    ring = PacketRing(packet_capacity=4096, n_slots=16, device="cpu", layout=layout)
    assert ring.stage_packets(ev)
    assert ring.packets_staged >= 3  # split by span, not capacity
    cap = 4096
    pkts, meta = ring.frame_meta(0, n, int(ev["t"][0]))
    got = assemble_ring_frame_compact(_rows(pkts)[0], meta, cap, layout)
    _assert_batch(got, JBatch.from_structured(ev, cap))


def test_ring_assembly_frame_larger_than_capacity():
    """A frame spanning more events than the batch capacity truncates
    exactly like EventBatch.from_structured -- including a packet that
    straddles the capacity boundary."""
    ev = _ring_events(np.random.default_rng(3), 3000)
    ring = PacketRing(packet_capacity=700, n_slots=16, device="cpu")
    for a in range(0, 3000, 700):
        assert ring.stage_packets(ev[a:a + 700])
    cap = 1500  # frame of 2600 events straddles packet 3 mid-slot
    pkts, meta = ring.frame_meta(100, 2700, int(ev["t"][100]))
    got = assemble_ring_frame(*_rows(pkts), meta, cap)
    _assert_batch(got, JBatch.from_structured(ev[100:2700], cap))


def test_ring_overrun_and_retire():
    rng = np.random.default_rng(4)
    ring = PacketRing(packet_capacity=64, n_slots=16, device="cpu")
    ev = _ring_events(rng, 64 * 16)
    assert ring.stage_packets(ev)  # fills all 16 slots
    extra = _ring_events(rng, 10)
    assert not ring.stage_packets(extra)  # overrun, numbering still advances
    assert ring.overruns == 1
    # the unstaged range is reported as a hole
    assert ring.frame_meta(64 * 16, 64 * 16 + 10, 0) is None
    # numbering stays aligned: the next staged packet lands after the hole
    ring.retire_below(64 * 4)
    assert len(ring._free) == 4
    more = _ring_events(rng, 30)
    assert ring.stage_packets(more)
    pkts, meta = ring.frame_meta(64 * 16 + 10, 64 * 16 + 40, int(more["t"][0]))
    assert pkts[0].gbase == 64 * 16 + 10 and pkts[0].count == 30


def test_ring_frame_meta_rejects_too_many_packets():
    ring = PacketRing(packet_capacity=16, n_slots=32, device="cpu")
    ev = _ring_events(np.random.default_rng(5), 16 * 9)
    assert ring.stage_packets(ev)  # 9 packets > RING_SLOTS_PER_FRAME
    assert ring.frame_meta(0, 16 * 9, int(ev["t"][0])) is None
    # but an 8-packet window works
    assert ring.frame_meta(0, 16 * 8, int(ev["t"][0])) is not None


@pytest.mark.parametrize("capacity", [4096, 1000])
def test_ring_frame_is_meta_and_bounds(capacity):
    """``PacketRing.frame`` (the pipe's ring dispatch) is ``frame_meta``
    of the frame's global range at its first event's time plus
    ``ring_time_bounds`` at the capacity, and None for an empty frame and
    for one that is not resident."""
    rng = np.random.default_rng(6)
    ring = PacketRing(packet_capacity=1000, n_slots=16, device="cpu")
    ev = _ring_events(rng, 3200)
    for a, b in zip([0] + OFFS[1:5], OFFS[1:5] + [3200]):
        assert ring.stage_packets(ev[a:b])
    for gs, ge in ((950, 3100), (0, 3200), (702, 800)):
        pkts, meta, bounds = ring.frame(gs, ev[gs:ge], capacity)
        want_pkts, want_meta = ring.frame_meta(gs, ge, int(ev["t"][gs]))
        assert [p.slot for p in pkts] == [p.slot for p in want_pkts]
        np.testing.assert_array_equal(meta, want_meta)
        assert bounds == ring_time_bounds(ev[gs:ge], capacity)
    assert ring.frame(10, ev[:0], capacity) is None
    # 11 free slots: the 12th and 13th chunks of this packet overrun
    assert not ring.stage_packets(_ring_events(rng, 1000 * 13))
    assert ring.frame(3200 + 1000 * 10, ev[:100], capacity) is not None
    assert ring.frame(3200 + 1000 * 11, ev[:100], capacity) is None


# -- against the JAX package's ring ------------------------------------------

@pytest.mark.parametrize("size", [(640, 480), (64, 48), (128, 96), (1280, 720), (2, 2),
                                  (1, 1), (4096, 4096), (1024, 1024), (1025, 511)])
def test_ring_layout_matches_jax(size):
    got, want = RingLayout.for_camera(*size), JLayout.for_camera(*size)
    assert (got is None) == (want is None)
    if got is not None:
        assert tuple(got) == tuple(want)


def _packet_stream(rng, n_packets, layout):
    """Arrival packets of random size (some longer than a slot, some
    spanning more than the layout's time field), every p = 1."""
    t0, packets = 2_000_000, []
    for _ in range(n_packets):
        n = int(rng.integers(1, 1500))
        span = int(rng.choice([3000, 4200, 9000]))
        ev = _ring_events(rng, n, t0=t0, span=span)
        ev["p"] = 1 if layout is not None else ev["p"]
        packets.append(ev)
        t0 += span + 40
    return packets


@pytest.mark.parametrize("compact", [True, False], ids=["one_word", "two_word"])
def test_packet_ring_matches_jax(compact):
    """Port and JAX PacketRings fed the same packet stream (with an
    overrun, skipped events and retires) give the same frame_meta, packet
    for packet, and equal assembled batches."""
    layout = RingLayout.for_camera(640, 480) if compact else None
    jlayout = JLayout.for_camera(640, 480) if compact else None
    rng = np.random.default_rng(6 + compact)
    ring = PacketRing(packet_capacity=1024, n_slots=16, device="cpu", layout=layout)
    jring = JRing(packet_capacity=1024, n_slots=16, layout=jlayout)
    cap = 3000
    if compact:
        jfn = jax.jit(lambda ws, m: j_assemble_compact(ws, m, cap, jlayout))
    else:
        jfn = jax.jit(lambda a, b, m: j_assemble(a, b, m, cap))
    stream, frames = [], 0
    for i, pkt in enumerate(_packet_stream(rng, 40, layout)):
        if i == 17:  # the watchdog is behind: numbering advances unstaged
            ring.skip_events(len(pkt))
            jring.skip_events(len(pkt))
        else:
            assert ring.stage_packets(pkt) == jring.stage_packets(pkt)
        stream.append(pkt)
        evs = np.concatenate(stream)
        base = len(evs) - 2500
        for gs, ge in ((base, len(evs) - 100), (base + 300, len(evs))):
            if gs < 0:
                continue
            got, want = (r.frame_meta(gs, ge, int(evs["t"][gs])) for r in (ring, jring))
            assert (got is None) == (want is None), (i, gs, ge)
            if got is None:
                continue
            (pkts, meta), (jpkts, jmeta) = got, want
            np.testing.assert_array_equal(meta, jmeta)
            assert [p[2:] for p in pkts] == [p[2:] for p in jpkts]
            xys, tps = _rows(pkts)
            if compact:
                port = assemble_ring_frame_compact(xys, meta, cap, layout)
                ref = jfn(tuple(p.xy for p in jpkts), jmeta)
            else:
                port = assemble_ring_frame(xys, tps, meta, cap)
                ref = jfn(tuple(p.xy for p in jpkts), tuple(p.tp for p in jpkts), jmeta)
            _assert_batch(port, ref, f"packet {i} [{gs}, {ge})")
            _assert_batch(port, JBatch.from_structured(evs[gs:ge], cap))
            frames += 1
        ring.retire_below(len(evs) - 3000)
        jring.retire_below(len(evs) - 3000)
    assert ring.overruns == jring.overruns and ring.packets_staged == jring.packets_staged
    assert frames > 30


# -- kernel 1's ring entry (plain version on the CPU) against JAX -------------

@pytest.fixture(scope="module")
def rig():
    """``__graft_entry__._make_rig`` sizes: camera 128x96 (ring layout 7 +
    7 + 18 bits), projector 180x320; both packages get the same tables."""
    calib, cfg, jtables, _ = __graft_entry__._make_rig()
    events = simulate_plane_events(calib, depth_m=0.6, subsample=0.5, jitter_us=2.0,
                                   rng=np.random.default_rng(3))
    ttables = DeviceTables.from_numpy(
        *(np.asarray(a) for a in (
            jtables.cam_mapx_i16, jtables.cam_mapy_i16, jtables.x_map,
            jtables.proj_mapx_i16, jtables.proj_mapy_i16, jtables.p03,
        )),
        device="cpu",
    )
    return cfg, jtables, ttables, events


def _views(cfg, camera_view):
    if camera_view:
        return dict(camera_view=True, window=(0, 0),
                    out_shape=(cfg.camera_height, cfg.camera_width))
    return dict(camera_view=False, window=(40, 60),
                out_shape=(cfg.rect_height - 90, cfg.rect_width - 130))


def _jax_scatter(cfg, jt, jbatch, camera_view):
    """JAX's per-event stage (time binned on the batch) and packed scatter."""
    res = jdisp.compute_event_disparity(jbatch, jt.cam_mapx_i16, jt.cam_mapy_i16, jt.x_map,
                                        t_px_scale=cfg.t_px_scale)
    kw = _views(cfg, camera_view)
    (oy, ox), (wh, ww) = kw["window"], kw["out_shape"]
    if camera_view:
        ys, xs, H, W = jbatch.y, jbatch.x, cfg.camera_height, cfg.camera_width
    else:
        ys, xs = res.y_rect, res.x_rect + res.disp.astype(jnp.int32)
        H, W = cfg.rect_height, cfg.rect_width
    packed = j_scatter(ys, xs, res.disp, res.inlier, height=H, width=W, window=(oy, ox, wh, ww))
    return np.asarray(packed), int(np.asarray(res.inlier).sum())


def _ring_frame(events, k, rng, layout, long_span):
    """The frame's events as k arrival packets with a partial first and last
    packet (events before and after the frame); with ``long_span`` each
    packet spans 200 ms, so t_rel sets bit 31 of the 7 + 7 + 18-bit word
    without a split."""
    ev = events.copy()
    ev["p"] = 1
    n = len(ev)
    cuts = np.sort(np.concatenate([
        [rng.integers(1, 100), rng.integers(n - 100, n - 1)],
        rng.choice(np.arange(100, n - 100), k - 1, replace=False)]))
    bounds = [0, *cuts[1:-1], n]
    if long_span:
        for j, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            ev["t"][a:b] = ev["t"][0] + 210_000 * j + np.sort(rng.integers(0, 200_000, b - a))
    ring = PacketRing(packet_capacity=n, n_slots=16, device="cpu", layout=layout)
    jring = JRing(packet_capacity=n, n_slots=16, layout=JLayout(*layout))
    for a, b in zip(bounds[:-1], bounds[1:]):
        for r in (ring, jring):
            assert r.stage_packets(ev[a:b])
    gs, ge = int(cuts[0]), int(cuts[-1])
    frame = ev[gs:ge]
    out, jout = (r.frame_meta(gs, ge, int(frame["t"][0])) for r in (ring, jring))
    np.testing.assert_array_equal(out[1], jout[1])
    assert len(out[0]) == k and out[1][0, 0] > 0 and out[1][0, -1] + out[1][1, -1] \
        < out[0][-1].count
    return frame, out, jout


@pytest.mark.parametrize("camera_view", [False, True], ids=["projector", "camera"])
@pytest.mark.parametrize("k", range(1, RING_SLOTS_PER_FRAME + 1))
def test_ring_entry_plain_matches_jax(rig, k, camera_view):
    """Kernel 1's ring entry on the CPU (its plain version) against JAX's
    ring assembly + per-event stage + packed scatter, at k packets with
    partial first and last packets, under and over the capacity, and with
    words whose bit 31 is set; the host time bounds equal the assembled
    batch's masked min and max."""
    cfg, jt, tt, events = rig
    layout = RingLayout.for_camera(cfg.camera_width, cfg.camera_height)
    assert layout == (7, 7, 18)
    rng = np.random.default_rng(10 * k + camera_view)
    kw = _views(cfg, camera_view)
    for long_span in (False, True):
        frame, (pkts, meta), (jpkts, jmeta) = _ring_frame(events, k, rng, layout, long_span)
        rows = tuple(p.xy for p in pkts)
        if long_span:
            assert (np.concatenate([r.numpy() for r in rows]).view(np.uint32) >> 31).any()
        assert len(frame) > 1024
        for cap in (4096, 1024):
            count = min(len(frame), cap)
            jb = j_assemble_compact(tuple(p.xy for p in jpkts), jmeta, cap, JLayout(*layout))
            want, inliers = _jax_scatter(cfg, jt, jb, camera_view)
            t_bounds = ring_time_bounds(frame, cap)
            jmin, jmax = jdisp.time_bounds(jb.t, jb.valid)
            assert t_bounds == (int(jmin), int(jmax))
            for fn in (event_disparity_scatter_ring, event_disparity_scatter_ring_plain):
                got = fn(rows, meta, count, t_bounds, layout, tt, t_px_scale=cfg.t_px_scale,
                         **kw)
                np.testing.assert_array_equal(got.packed_map.numpy().view(np.uint32), want)
                assert int(got.num_inliers) == inliers > 100


def test_ring_entry_refusals(rig):
    """The ring entry refuses rows neither on the CPU nor on CUDA, 0 or 9
    packets, and a count of 0, past the frame's events or past the uint32
    packing's capacity -- on CPU rows too."""
    from xmaps_tpu_torch.ops.scatter import MAX_CAPACITY

    cfg, jt, tt, events = rig
    kw = dict(t_px_scale=cfg.t_px_scale, camera_view=True, window=(0, 0), out_shape=(4, 4))
    layout = RingLayout(7, 7, 18)
    meta = np.array([[0], [3], [0]], np.int32)
    row = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        event_disparity_scatter_ring((row,), meta, 3, (0, 1), layout, tt, **kw)
    row = torch.zeros(MAX_CAPACITY + 8, dtype=torch.int32)
    for rows, m, count in (((), meta[:, :0], 1), ((row,) * 9, np.tile(meta, 9), 3),
                           ((row,), meta, 0), ((row,), meta, 4),
                           ((row,), np.array([[0], [MAX_CAPACITY + 1], [0]], np.int32),
                            MAX_CAPACITY + 1)):
        with pytest.raises(ValueError, match="packets|count"):
            event_disparity_scatter_ring(rows, m, count, (0, 1), layout, tt, **kw)


# -- the engine's process_ring against the JAX engine's -----------------------

CAPACITY = 4096


@functools.lru_cache(maxsize=None)
def _engines(camera_perspective):
    kw = dict(event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
              camera_perspective=camera_perspective)
    return (JEngine.from_calibration(j_calib(), **kw),
            XMapsDepthEngine.from_calibration(make_synthetic_calibration(), device="cpu", **kw))


def _engine_frames():
    """Three plane frames of the small rig (~2-4k events) and, over the
    capacity, their concatenation cut to 5000 events."""
    calib = make_synthetic_calibration()
    rng = np.random.default_rng(12)
    frames = []
    t0 = 1_000_000
    for d, s in ((0.5, 0.3), (0.7, 0.6), (0.9, 0.5)):
        ev = simulate_plane_events(calib, depth_m=d, subsample=s, jitter_us=2.0, rng=rng)
        ev["t"] += t0 - ev["t"][0]
        ev["p"] = 1
        t0 = int(ev["t"][-1]) + 1000
        frames.append(ev)
    return frames + [np.concatenate(frames)[:5000]]


@pytest.mark.parametrize("camera_perspective", [False, True], ids=["projector", "camera"])
@pytest.mark.parametrize("frame_filter", ["none", "first_per_yt", "mean_first_last_per_xy"])
def test_process_ring_matches_jax(camera_perspective, frame_filter):
    """``process_ring`` against the JAX engine's on the same packets, each
    frame as 4 arrival packets of both rings (1-word: with the host time
    bounds, the ring entry unfiltered; without them, the torch assembly;
    and a 2-word ring): the packed-BGR plane and the inlier count, bit for
    bit, unfiltered and with a dedup filter."""
    jeng, teng = _engines(camera_perspective)
    assert tuple(teng.ring_layout) == tuple(jeng.ring_layout)
    try:
        jeng.set_frame_filter(frame_filter)
        teng.set_frame_filter(frame_filter)
        for layout in (teng.ring_layout, None):
            ring = PacketRing(packet_capacity=2048, n_slots=16, device="cpu", layout=layout)
            jring = JRing(packet_capacity=2048, n_slots=16,
                          layout=jeng.ring_layout if layout else None)
            base = 0
            for ev in _engine_frames():
                for part in np.array_split(ev, 4):
                    assert ring.stage_packets(part) and jring.stage_packets(part)
                (pkts, meta), (jpkts, jmeta) = (
                    r.frame_meta(base, base + len(ev), int(ev["t"][0])) for r in (ring, jring))
                want = jeng.process_ring(jpkts, jmeta)
                runs = [teng.process_ring(pkts, meta)]
                if layout is not None:
                    runs.append(teng.process_ring(pkts, meta,
                                                  ring_time_bounds(ev, CAPACITY)))
                for got in runs:
                    assert got.depth is None and got.frame_bgr.dtype == torch.int32
                    np.testing.assert_array_equal(got.frame_bgr.numpy().view(np.uint32),
                                                  np.asarray(want.frame_bgr))
                    assert int(got.num_inliers) == int(want.num_inliers) > 100
                base += len(ev)
                ring.retire_below(base)
                jring.retire_below(base)
    finally:
        jeng.set_frame_filter("none")
        teng.set_frame_filter("none")


def test_process_ring_checks_packets():
    """``process_ring`` refuses 0 or more than RING_SLOTS_PER_FRAME packets
    and a meta of another shape (the JAX engine's assertions)."""
    teng = _engines(False)[1]
    ring = PacketRing(packet_capacity=64, n_slots=32, device="cpu", layout=teng.ring_layout)
    ev = _engine_frames()[0][:64 * 9]
    assert ring.stage_packets(ev)
    pkts = ring._live
    with pytest.raises(ValueError, match="packets"):
        teng.process_ring([], np.zeros((3, 0), np.int32))
    with pytest.raises(ValueError, match="packets"):
        teng.process_ring(pkts, np.zeros((3, 9), np.int32))
    with pytest.raises(ValueError, match="packets"):
        teng.process_ring(pkts[:2], np.zeros((3, 3), np.int32))
