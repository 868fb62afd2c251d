"""The native group staging (``io.stage_pack``: the scan and the 1-word pack
of ``io.prefetch.stage_compact_group``) against its plain NumPy version
(``fits_layout`` and ``_pack_compact_numpy``), word for word and count for
count, and ``process_frames`` on it against the NumPy route.

These tests import nothing of JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmaps_tpu_torch.config import PipelineConfig  # noqa: E402
from xmaps_tpu_torch.io import prefetch, stage_pack  # noqa: E402
from xmaps_tpu_torch.io.evt_decoder import EVENT_DTYPE  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine  # noqa: E402
from xmaps_tpu_torch.ops import staged  # noqa: E402
from xmaps_tpu_torch.ops.event_batch import EventBatch  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import simulate_plane_events  # noqa: E402


def _layout(projector_width: int) -> staged.CompactLayout:
    """The 1-word layout of a 640x480 camera beside a projector
    ``projector_width`` wide (the demonstrator 720, the ESL rig 1080)."""
    return staged.CompactLayout.for_pipeline(PipelineConfig(
        camera_width=640, camera_height=480, projector_width=projector_width,
        projector_height=1280, rect_width=1760, rect_height=1320))


DEMO, ESL = _layout(720), _layout(1080)
#: a scale of 2 mod 4: over a time range of 4 K, the offsets K and 3 K fall
#: exactly half-way, between the bins 179 and 180 (odd: rounds up) and 538
#: and 539 (even: stays)
TIES = staged.CompactLayout(10, 9, 10, 718)


def _frame(n, rng, *, t0=10**9, span=16666, dtype=EVENT_DTYPE, sort=True):
    """``n`` events of a 640x480 camera over ``span`` µs from ``t0``."""
    ev = np.zeros(n, dtype)
    ev["x"] = rng.integers(0, 640, n)
    ev["y"] = rng.integers(0, 480, n)
    ev["p"] = 1
    t = t0 + rng.integers(0, span + 1, n)
    ev["t"] = np.sort(t) if sort else t
    return ev


def _ties(k, reps, rng):
    """Events at t0 + {0, K, 2K, 3K, 4K}, ``reps`` of each, shuffled."""
    ev = _frame(5 * reps, rng)
    ev["t"] = 10**9 + rng.permutation(np.repeat(np.arange(5) * k, reps))
    return ev


def _past(ev, field, at):
    """``ev`` with event ``at``'s ``field`` one past the demonstrator's layout."""
    ev = ev.copy()
    ev[field][at] = 1 << (DEMO.bits_x if field == "x" else DEMO.bits_y)
    return ev


def _retyped(ev, **types):
    dt = [(k, types.get(k, EVENT_DTYPE[k].str)) for k in EVENT_DTYPE.names]
    return ev.astype(dt)


def _case(name):
    """(frames, layout, capacity, the routes the native scan must give)."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "demo_random":  # frames with fewer and more µs than events
        frames = [_frame(n, rng, t0=10**9 + 16666 * i, sort=i % 2 == 0)
                  for i, n in enumerate((20000, 3000, 16667, 16666))]
        return frames, DEMO, 28672, (True,) * 4
    if name == "esl_random":
        frames = [_frame(27648, rng), _frame(500, rng, span=10**6)]
        return frames, ESL, 28672, (True, True)
    if name == "empty_and_one_event":
        return [_frame(0, rng), _frame(1, rng), _frame(0, rng)], DEMO, 64, (True,) * 3
    if name == "one_timestamp":
        frames = [_frame(100, rng, span=0), _frame(3, rng, span=0)]
        return frames, DEMO, 128, (True, True)
    if name == "half_way_dense":  # range 4, 500 events
        return [_ties(1, 100, rng)], TIES, 1024, (True,)
    if name == "half_way_sparse":  # range 40028, 20 events
        return [_ties(10007, 4, rng)], TIES, 1024, (True,)
    if name == "every_offset":  # every offset of small ranges, each bin boundary among them
        frames = []
        for r in (1, 2, 3, 5, 7, 64, 718, 719, 720, 1438, 1439, 5000):
            ev = _frame(r + 1, rng)
            ev["t"] = 10**9 + rng.permutation(r + 1)
            frames.append(ev)
        return frames, DEMO, 8192, (True,) * len(frames)
    if name == "exact_quotient":  # the double product lands just below 719
        ev = _frame(4, rng)
        ev["t"] = 10**9 + np.array([0, 3635710090325, 1817855045162, 3635710090325])
        return [ev], DEMO, 16, (True,)
    if name == "longer_than_capacity":  # the range over the first 1000 only
        ev = _frame(1500, rng, sort=False)
        ev["t"][1000:] = [10**8, 2 * 10**9] * 250
        ev["x"][1000:] = 639
        return [ev, _frame(800, rng)], DEMO, 1000, (True, True)
    if name == "past_layout_beyond_capacity":  # the fit over every event
        return [_past(_frame(1500, rng), "y", 1400)], DEMO, 1000, (True,)
    if name == "x_past_layout":
        return [_frame(300, rng), _past(_frame(300, rng), "x", 7)], DEMO, 512, (True, True)
    if name == "y_past_layout":
        return [_past(_frame(300, rng), "y", 299)], DEMO, 512, (True,)
    if name == "strided_views":  # every other record, reversed, padded records: NumPy's pack
        big = _frame(4000, rng, sort=False)
        padded = np.zeros(900, np.dtype({"names": ["t", "p", "y", "x"],
                                         "formats": ["<i8", "<i2", "<u2", "<u2"],
                                         "offsets": [0, 12, 16, 20], "itemsize": 24}))
        for k in padded.dtype.names:
            padded[k] = big[k][:900]
        dense = padded.copy()  # range 500, 900 events
        dense["t"] = 10**9 + rng.integers(0, 501, 900)
        frames = [big[::2], big[::-3], padded, dense]
        assert not any(f.flags.c_contiguous for f in frames[:2])
        return frames, DEMO, 2048, (False,) * 4
    if name == "t_int32":
        return [_retyped(_frame(700, rng, t0=10**6), t="<i4")], DEMO, 1024, (False,)
    if name == "x_int32":
        return [_retyped(_frame(700, rng), x="<i4")], DEMO, 1024, (False,)
    if name == "mixed_routes":
        frames = [_frame(700, rng), _retyped(_frame(700, rng), y="<u4"), _frame(5, rng)]
        return frames, ESL, 1024, (True, False, True)
    if name == "range_past_doubles":  # range x scale >= 2**52: NumPy's binning
        ev = _frame(600, rng)
        ev["t"][::2] += 1 << 43
        return [ev, _frame(600, rng)], DEMO, 1024, (False, True)
    raise KeyError(name)


CASES = ("demo_random", "esl_random", "empty_and_one_event", "one_timestamp",
         "half_way_dense", "half_way_sparse", "every_offset", "exact_quotient", "longer_than_capacity",
         "past_layout_beyond_capacity", "x_past_layout", "y_past_layout", "strided_views",
         "t_int32", "x_int32", "mixed_routes", "range_past_doubles")


@pytest.mark.parametrize("name", CASES)
def test_native_scan_and_pack_equal_numpy(name):
    """``scan_group`` gives ``fits_layout``'s answer and the frames' time
    ranges, and ``stage_compact_group``'s rows and counts are the NumPy
    pack's, word for word, on either route."""
    frames, layout, cap, routes = _case(name)
    scan = prefetch.scan_group(frames, layout, cap)
    assert scan.fits == all(prefetch.fits_layout(ev, layout) for ev in frames)
    assert scan.native == routes
    assert scan.read == tuple(i for i, ev in enumerate(frames) if ev.dtype == EVENT_DTYPE
                              and (len(ev) < 2 or ev.strides[0] == EVENT_DTYPE.itemsize))
    for i, lo, hi in zip(scan.read, scan.t_lo, scan.t_hi):
        t = frames[i]["t"][:cap]
        assert (lo, hi) == ((t.min(), t.max()) if len(t) else (0, 0))
    group = prefetch.stage_compact_group(frames, cap, layout, device="cpu", scan=scan)
    assert group.word.shape == (len(frames), cap)
    for f, ev in enumerate(frames):
        n = min(len(ev), cap)
        want = np.full(cap, 0xFFFFFFFF, np.uint32)
        prefetch._pack_compact_numpy(ev, n, layout, want)
        np.testing.assert_array_equal(group.word[f].numpy().view(np.uint32), want)
        assert group.host_counts[f] == int(group.counts[f]) == n
    # the single-frame pack of the segmented staging takes the same words
    pool = prefetch.HostStagingPool(cap, device="cpu", layout=layout)
    for f, ev in enumerate(frames):
        assert torch.equal(pool.stage_compact(ev).word, group.word[f])


def test_scan_fits_matches_each_case():
    """The cases above cover both answers of the fit and both routes."""
    fits = {}
    for name in CASES:
        frames, layout, cap, _ = _case(name)
        fits[name] = prefetch.scan_group(frames, layout, cap).fits
    assert not fits["x_past_layout"] and not fits["y_past_layout"]
    assert not fits["past_layout_beyond_capacity"]
    assert fits["longer_than_capacity"] and fits["demo_random"]
    assert stage_pack.native_fields(np.zeros(3, EVENT_DTYPE))
    assert not stage_pack.native_fields(np.zeros((2, 3), EVENT_DTYPE))
    assert not stage_pack.native_fields(np.zeros(6, EVENT_DTYPE)[::2])
    assert not stage_pack.native_fields(np.zeros(3, np.int64))


def test_mismatched_scan_raises():
    """``stage_compact_group`` refuses a scan made at another capacity or
    over other frames, whose time ranges need not bound the events it
    would pack."""
    rng = np.random.default_rng(3)
    frames = [_frame(300, rng), _frame(200, rng)]
    scan = prefetch.scan_group(frames, DEMO, 256)
    for other, cap in ((frames, 512), ([frames[0], frames[1].copy()], 256), (frames[:1], 256),
                       ([frames[0][:100], frames[1]], 256), (frames + frames[:1], 256)):
        with pytest.raises(ValueError, match="scan"):
            prefetch.stage_compact_group(other, cap, DEMO, device="cpu", scan=scan)
    group = prefetch.stage_compact_group(frames, 256, DEMO, device="cpu", scan=scan)
    assert group.host_counts == (256, 200)


def test_pack_clamps_times_outside_the_scan():
    """Events whose ``t`` lies outside the range handed to the native pack
    (here below and above it, on the tabulated route) get the top bin, a
    wrong word but no read outside the bin table (an unclamped offset below
    the range would be ~2**64); the others get their exact bins."""
    rng = np.random.default_rng(5)
    ev = _frame(1000, rng, span=500)
    lo, hi = 10**9 + 100, 10**9 + 400
    row = np.full(1024, 0xFFFFFFFF, np.uint32)
    stage_pack.pack(stage_pack.addresses([ev]), [row], [1000], 1024, DEMO.bits_x, DEMO.bits_y,
                    DEMO.t_px_scale, [lo], [hi])
    q, r = np.divmod((ev["t"] - lo) * DEMO.t_px_scale, hi - lo)
    ts = q + ((2 * r > hi - lo) | ((2 * r == hi - lo) & (q % 2 == 1)))
    ts = np.where((ev["t"] >= lo) & (ev["t"] <= hi), ts, DEMO.t_px_scale)
    want = (ts.astype(np.uint32) << (DEMO.bits_x + DEMO.bits_y)
            | ev["y"].astype(np.uint32) << DEMO.bits_x | ev["x"])
    assert ((ev["t"] < lo).any() and (ev["t"] > hi).any())
    np.testing.assert_array_equal(row[:1000], want)
    assert not row[1000:].any()


def test_single_frame_pack_skips_the_fit(monkeypatch):
    """The segmented staging's one-frame pack takes the NumPy pack for other
    field types and the native one for the decoder's, without checking the
    pixels' fit (its callers do not ask it): a pixel past the layout beyond
    the staged events costs nothing and changes no word."""
    rng = np.random.default_rng(4)
    native = _past(_frame(1500, rng), "y", 1400)
    other = _retyped(_frame(700, rng), x="<i4")
    want = {}
    for name, ev in (("native", native), ("other", other)):
        want[name] = np.full(1000, 0xFFFFFFFF, np.uint32)
        prefetch._pack_compact_numpy(ev, min(len(ev), 1000), DEMO, want[name])

    def refuse(*_):
        raise AssertionError("fits_layout ran")

    monkeypatch.setattr(prefetch, "fits_layout", refuse)
    pool = prefetch.HostStagingPool(1000, device="cpu", layout=DEMO)
    for name, ev in (("native", native), ("other", other)):
        got = pool.stage_compact(ev)
        assert got.count == min(len(ev), 1000)
        np.testing.assert_array_equal(got.word.numpy().view(np.uint32), want[name])


@pytest.fixture(scope="module")
def engine():
    return XMapsDepthEngine.from_calibration(make_synthetic_calibration(), device="cpu",
                                             event_capacity=2048, z_near=0.2, z_far=1.2,
                                             camera_perspective=True)


def test_process_frames_native_equals_numpy_route(engine):
    """A CPU ``process_frames`` group staged natively gives the outputs of the
    same frames staged by the NumPy route (``x`` as ``<i4``), and a group
    with a pixel past the layout takes the stacked 2-word staging."""
    calib = make_synthetic_calibration()
    rng = np.random.default_rng(11)
    frames = [simulate_plane_events(calib, depth_m=0.45 + 0.05 * i, subsample=0.3, rng=rng)
              for i in range(4)]
    frames.append(frames[0][:0])
    other = [_retyped(ev, x="<i4") for ev in frames]
    layout = engine.compact_layout
    assert all(prefetch.scan_group(frames, layout, 2048).native)
    assert not any(prefetch.scan_group(other, layout, 2048).native)
    got = engine.process_frames(frames)
    want = engine.process_frames(other)
    assert sum(int(r.num_inliers) for r in got) > 0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)
    wide = [frames[0], frames[1].copy()]
    wide[1]["x"][0] = 1 << layout.bits_x
    assert isinstance(engine.stage_group(wide), EventBatch)
    assert isinstance(engine.stage_group(frames), staged.CompactStagedGroup)
