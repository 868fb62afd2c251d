"""The port's event I/O (``xmaps_tpu_torch.io``) vs the JAX package's.

Decoders, encoder, packet iterator, activity filter and staging are held
against ``xmaps_tpu.io`` on the same inputs, made from numpy seeds; every
comparison is exact.  The JAX side is compared through its NumPy decoders
and NumPy activity filter (the ground truth its own tests hold its native
library to), so these tests never start a build of the JAX package's
library.  The port's native library is built inside the tests, through its
atomic builder, never while a module is imported.
"""

import ctypes
import struct
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_decoder_spec_vectors import (  # noqa: E402
    EVT2_EXPECT,
    EVT2_WORDS,
    EVT3_EXPECT,
    EVT3_WORDS,
    _evt2_raw,
    _evt3_raw,
)
from xmaps_tpu.config import PipelineConfig as JConfig  # noqa: E402
from xmaps_tpu.io import evt_decoder as jdec  # noqa: E402
from xmaps_tpu.io import evt_encode as jenc  # noqa: E402
from xmaps_tpu.io.event_iterator import FileEventsIterator as JIter  # noqa: E402
from xmaps_tpu.io.filters import ActivityNoiseFilter as JFilter  # noqa: E402
from xmaps_tpu.io.prefetch import CompactLayout as JLayout  # noqa: E402
from xmaps_tpu.io.prefetch import HostStagingPool as JPool  # noqa: E402
from xmaps_tpu.io.prefetch import unpack_staged as j_unpack  # noqa: E402
from xmaps_tpu.io.prefetch import unpack_staged_compact as j_unpack_compact  # noqa: E402

from xmaps_tpu_torch.config import PipelineConfig  # noqa: E402
from xmaps_tpu_torch.io import evt_decoder as tdec  # noqa: E402
from xmaps_tpu_torch.io import evt_encode as tenc  # noqa: E402
from xmaps_tpu_torch.io import prefetch  # noqa: E402
from xmaps_tpu_torch.io.event_iterator import FileEventsIterator  # noqa: E402
from xmaps_tpu_torch.io.filters import ActivityNoiseFilter, polarity_filter  # noqa: E402
from xmaps_tpu_torch.ops import _build, staged  # noqa: E402

torch.set_num_threads(1)

ENCODERS = ("encode_evt2", "encode_evt3", "encode_dat")
SUFFIX = {"encode_evt2": "raw", "encode_evt3": "raw", "encode_dat": "dat"}


def _events(rng, n=5000, w=640, h=480, t_span=100_000, t0=0):
    ev = np.zeros(n, dtype=tdec.EVENT_DTYPE)
    ev["x"] = rng.integers(0, w, n)
    ev["y"] = rng.integers(0, h, n)
    ev["p"] = rng.integers(0, 2, n)
    ev["t"] = t0 + np.sort(rng.integers(0, t_span, n))
    return ev


@pytest.fixture(scope="module")
def native():
    return tdec.load_native()


@pytest.fixture(scope="module")
def events():
    return _events(np.random.default_rng(3))


def _jax_numpy_decode(raw: bytes, dat: bool) -> np.ndarray:
    """The JAX package's NumPy decoders on a file's bytes."""
    hdr_len, fmt, _ = jdec.parse_raw_header(raw)
    payload = raw[hdr_len:]
    if dat:
        payload = payload[2:]
        return jdec.decode_dat_numpy(np.frombuffer(payload[: len(payload) // 8 * 8], "<u4"))
    if fmt == "EVT3":
        return jdec.decode_evt3_numpy(np.frombuffer(payload[: len(payload) // 2 * 2], "<u2"))
    return jdec.decode_evt2_numpy(np.frombuffer(payload[: len(payload) // 4 * 4], "<u4"))


def test_event_dtype_equal():
    assert tdec.EVENT_DTYPE == jdec.EVENT_DTYPE


@pytest.mark.parametrize("enc", ENCODERS)
def test_encoder_bytes_equal_jax(events, enc):
    assert getattr(tenc, enc)(events, 640, 480) == getattr(jenc, enc)(events, 640, 480)


@pytest.mark.parametrize("force_numpy", [False, True], ids=["native", "numpy"])
@pytest.mark.parametrize("enc", ENCODERS)
def test_decode_file_matches_jax(native, tmp_path, events, enc, force_numpy):
    raw = getattr(jenc, enc)(events, 640, 480)
    path = tmp_path / f"ev.{SUFFIX[enc]}"
    path.write_bytes(raw)
    got = tdec.decode_file(str(path), force_numpy=force_numpy)
    want = _jax_numpy_decode(raw, dat=enc == "encode_dat")
    assert got.dtype == want.dtype and len(got) == len(events)
    np.testing.assert_array_equal(got, want)
    dec = tdec.EvtDecoder(str(path), force_numpy=force_numpy)
    if enc != "encode_dat":
        assert (dec.width, dec.height) == (640, 480)
    dec.close()


def test_native_chunks_lose_no_events(native, tmp_path, events):
    path = tmp_path / "ev.raw"
    path.write_bytes(jenc.encode_evt3(events, 640, 480))
    dec = tdec.EvtDecoder(str(path), chunk_events=777)
    chunks = list(dec)
    dec.close()
    assert max(len(c) for c in chunks) <= 777
    np.testing.assert_array_equal(np.concatenate(chunks), _jax_numpy_decode(
        path.read_bytes(), dat=False))


@pytest.mark.parametrize("force_numpy", [False, True], ids=["native", "numpy"])
@pytest.mark.parametrize("fmt", ["evt3", "evt2"])
def test_spec_vectors(native, tmp_path, fmt, force_numpy):
    """The hand-built spec streams of tests/test_decoder_spec_vectors.py."""
    raw = _evt3_raw(EVT3_WORDS) if fmt == "evt3" else _evt2_raw(EVT2_WORDS)
    expect = EVT3_EXPECT if fmt == "evt3" else EVT2_EXPECT
    path = tmp_path / "spec.raw"
    path.write_bytes(raw)
    got = tdec.decode_file(str(path), force_numpy=force_numpy)
    assert [tuple(int(v) for v in (e["x"], e["y"], e["p"], e["t"])) for e in got] == expect
    np.testing.assert_array_equal(got, _jax_numpy_decode(raw, dat=False))


def test_header_dialects(native, tmp_path):
    payload3 = struct.pack("<4H", (0x8 << 12) | 1, (0x6 << 12) | 2, (0x0 << 12) | 3,
                           (0x2 << 12) | 4)
    p3 = tmp_path / "d3.raw"
    p3.write_bytes(b"% evt 3.0\n% geometry 640x480\n% end\n" + payload3)
    payload2 = struct.pack("<2I", (0x8 << 28) | 1, (0x1 << 28) | (3 << 22) | (4 << 11) | 5)
    p2 = tmp_path / "d2.raw"
    p2.write_bytes(b"% evt 2.0\n% geometry 640x480\n% end\n" + payload2)
    for force_numpy in (False, True):
        assert tdec.decode_file(str(p3), force_numpy)["t"].tolist() == [(1 << 12) | 2]
        assert tdec.decode_file(str(p2), force_numpy)["t"].tolist() == [(1 << 6) | 3]
    for raw in (p3.read_bytes(), p2.read_bytes()):
        assert tdec.parse_raw_header(raw) == jdec.parse_raw_header(raw)


def test_native_library_is_the_ports_own(native):
    """The port builds csrc/evt_decoder.cpp into its own build directory,
    keyed by the source hash; it never loads the JAX package's library."""
    path = tdec._lib_path()
    assert path.parent == _build.build_dir()
    assert path.exists() and path.name.startswith("libevt_decoder-")
    assert "xmaps_tpu/io" not in str(path)


def test_native_build_is_atomic(tmp_path, monkeypatch):
    """Four concurrent builders of one library: each compiles under a
    temporary name and renames it into place, so the target is always a
    whole library and no temporary file is left behind."""
    monkeypatch.setenv("XMAPS_TORCH_BUILD_DIR", str(tmp_path))
    target = tdec._lib_path()
    assert target.parent == tmp_path
    errors = []

    def build():
        try:
            tdec._build(target)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sorted(p.name for p in tmp_path.iterdir()) == [target.name]
    assert ctypes.CDLL(str(target)).evt_open is not None


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tdec._build(tmp_path / "lib.so")
    assert list(tmp_path.iterdir()) == []


def test_iterator_packets_match_jax(native, tmp_path, events):
    path = tmp_path / "ev.raw"
    path.write_bytes(jenc.encode_evt3(events, 640, 480))
    got = list(FileEventsIterator(str(path), delta_t=4166.67))
    want = list(JIter(str(path), delta_t=4166.67))
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert FileEventsIterator(str(path), delta_t=1000).get_size() == (480, 640)


def test_polarity_filter(events):
    from xmaps_tpu.io.filters import polarity_filter as j_pol

    np.testing.assert_array_equal(polarity_filter(events, 1), j_pol(events, 1))


def _correlated_packets(seed, n_packets=6, per=3000, w=96, h=64):
    """Time-ordered packets with clustered pixels, so both the cross-packet
    state and the within-packet unlocks decide events."""
    rng = np.random.default_rng(seed)
    out, t0 = [], 0
    for _ in range(n_packets):
        ev = np.zeros(per, dtype=tdec.EVENT_DTYPE)
        cx, cy = rng.integers(0, w, per // 50), rng.integers(0, h, per // 50)
        k = rng.integers(0, len(cx), per)
        ev["x"] = np.clip(cx[k] + rng.integers(-2, 3, per), 0, w - 1)
        ev["y"] = np.clip(cy[k] + rng.integers(-2, 3, per), 0, h - 1)
        ev["p"] = rng.integers(0, 2, per)
        ev["t"] = t0 + np.sort(rng.integers(0, 4000, per))
        t0 += 4000
        out.append(ev)
    return out


@pytest.mark.parametrize("force_numpy", [False, True], ids=["native", "numpy"])
def test_activity_filter_matches_jax(native, force_numpy):
    """Stateful over packets, through a reset, equal to the JAX filter's
    exact NumPy version."""
    packets = _correlated_packets(11)
    got_f = ActivityNoiseFilter(96, 64, window_us=1000, force_numpy=force_numpy)
    want_f = JFilter(96, 64, window_us=1000, force_numpy=True)
    kept = 0
    for i, pkt in enumerate(packets):
        if i == 4:
            got_f.reset()
            want_f.reset()
        got, want = got_f.process(pkt), want_f.process(pkt)
        np.testing.assert_array_equal(got, want)
        kept += len(got)
    assert 0 < kept < sum(len(p) for p in packets) // 2


# -- staging ------------------------------------------------------------------


def _assert_batch_equal(got, want):
    for name in ("x", "y", "t", "p", "valid", "count"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("sizes", [(100, 700, 300), (512, 512), (600, 0, 10)])
def test_stage_matches_jax(sizes):
    """unpack_staged(stage(ev)) equals the JAX pool's, frame by frame,
    through slot reuse, truncation and an empty frame."""
    rng = np.random.default_rng(sum(sizes))
    cap = 512
    pool, jpool = prefetch.HostStagingPool(cap, depth=2, device="cpu"), JPool(cap, depth=2)
    for i, n in enumerate(sizes):
        ev = _events(rng, n, t0=1_000_000 * (i + 1), t_span=16_000)
        got = staged.unpack_staged(pool.stage(ev))
        _assert_batch_equal(got, j_unpack(jpool.stage(ev)))
        assert got.x.dtype == torch.int32 and got.valid.dtype == torch.bool
    assert pool.frames_staged == jpool.frames_staged == len(sizes)
    assert pool.events_truncated == jpool.events_truncated == sum(max(0, n - 512) for n in sizes)


@pytest.mark.parametrize("cam", [(640, 480), (64, 48)])
def test_stage_compact_matches_jax(cam):
    cfg = PipelineConfig(cam[0], cam[1], 720, 1280, 1760, 1320, event_capacity=512)
    jcfg = JConfig(cam[0], cam[1], 720, 1280, 1760, 1320, event_capacity=512)
    layout = staged.CompactLayout.for_pipeline(cfg)
    assert tuple(layout) == tuple(JLayout.for_pipeline(jcfg))
    rng = np.random.default_rng(cam[0])
    pool = prefetch.HostStagingPool(512, depth=2, device="cpu", layout=layout)
    jpool = JPool(512, depth=2, layout=JLayout.for_pipeline(jcfg))
    for i, n in enumerate((300, 700, 0, 5)):
        ev = _events(rng, n, w=cam[0], h=cam[1], t0=7_000 * i, t_span=16_000)
        batch, ts = staged.unpack_staged_compact(pool.stage_compact(ev), layout)
        jbatch, jts = j_unpack_compact(jpool.stage_compact(ev), JLayout.for_pipeline(jcfg))
        _assert_batch_equal(batch, jbatch)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))


def test_host_time_binning_matches_jax():
    from xmaps_tpu.io.prefetch import _scale_time_int_host as j_bin

    rng = np.random.default_rng(2)
    for n, span, scale in ((1, 10, 719), (1000, 16_000, 719), (999, 8, 89), (0, 1, 5)):
        t = 5_000 + np.sort(rng.integers(0, span, n))
        np.testing.assert_array_equal(prefetch._scale_time_int_host(t, scale), j_bin(t, scale))


def test_compact_layout_none_when_oversize():
    cfg = PipelineConfig(1 << 12, 1 << 12, 1 << 10, 4, 5, 6)
    jcfg = JConfig(1 << 12, 1 << 12, 1 << 10, 4, 5, 6)
    assert staged.CompactLayout.for_pipeline(cfg) is None
    assert JLayout.for_pipeline(jcfg) is None
    with pytest.raises(ValueError, match="layout"):
        prefetch.HostStagingPool(16, device="cpu").stage_compact(np.zeros(3, tdec.EVENT_DTYPE))


def test_staging_slots_reused_and_copies_independent():
    """The pool fills its preallocated slots in place; a staged batch is a
    copy, so refilling the slot later does not change it."""
    rng = np.random.default_rng(4)
    pool = prefetch.HostStagingPool(256, depth=2, device="cpu")
    ids = [id(s.tensors["xy"]) for s in pool._slots]
    first = pool.stage(_events(rng, 200))
    keep = first.xy.clone()
    for i in range(5):
        pool.stage(_events(rng, 100 + i))
    assert [id(s.tensors["xy"]) for s in pool._slots] == ids
    assert torch.equal(first.xy, keep)
    with pytest.raises(ValueError, match="2 slots"):
        prefetch.HostStagingPool(16, depth=1, device="cpu")


# -- kernel W (the bench warm-up) -------------------------------------------


def test_warmup_plain_matches_pallas_noop():
    """The plain version of kernel W equals the JAX bench's _noop Pallas
    kernel (bench.py:93-103) run in interpret mode, on an (8, 128) int32
    tile of random values."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from xmaps_tpu_torch.ops.warmup import WARMUP_SHAPE, warmup_add_one

    def _noop(x_ref, o_ref):
        o_ref[:] = x_ref[:] + 1

    x = np.random.default_rng(9).integers(-(2**31), 2**31 - 1, WARMUP_SHAPE, dtype=np.int32)
    want = pl.pallas_call(
        _noop, out_shape=jax.ShapeDtypeStruct(WARMUP_SHAPE, jnp.int32), interpret=True,
    )(jnp.asarray(x))
    got = warmup_add_one(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="unsupported device"):
        warmup_add_one(torch.zeros(WARMUP_SHAPE, dtype=torch.int32, device="meta"))
