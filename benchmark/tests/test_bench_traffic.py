"""The traffic comes from the seed alone: one seed gives the same events,
two seeds different ones with the same amount of work, and the cache
hands back what the generator made."""

import os

import numpy as np
import pytest

from benchmark import generator, harness
from benchmark.tests.conftest import DATA

CFG = harness.load_json(os.path.join(DATA, "configs", "tiny.json"))
STREAM = harness.load_json(os.path.join(DATA, "benchmark", "traffic", "live_60hz.json"))
GROUPS = harness.load_json(os.path.join(DATA, "benchmark", "traffic", "batch_groups.json"))
BIG = 2**33 + 17


def same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("make,traffic", [(generator.loop_frames, STREAM),
                                          (lambda c, t, s: sum(generator.group_frames(c, t, s), []),
                                           GROUPS)], ids=["stream", "groups"])
def test_seed_decides_the_events(make, traffic):
    a, b, c = make(CFG, traffic, BIG), make(CFG, traffic, BIG), make(CFG, traffic, BIG + 1)
    assert same(a, b)
    assert not same(a, c)
    # the same depths in another order: the same work to within the draws
    assert abs(sum(map(len, a)) - sum(map(len, c))) < 0.05 * sum(map(len, a))


def test_cache_keyed_on_seed_and_config(tmp_path):
    a = generator.cached_frames(str(tmp_path), CFG, STREAM, BIG)
    assert same(a, generator.loop_frames(CFG, STREAM, BIG))
    assert same(generator.cached_frames(str(tmp_path), CFG, STREAM, BIG), a)
    assert len(os.listdir(tmp_path)) == 1
    generator.cached_frames(str(tmp_path), CFG, STREAM, BIG + 1)
    generator.cached_frames(str(tmp_path), {**CFG, "z_far": 2.0}, STREAM, BIG)
    assert len(os.listdir(tmp_path)) == 3


def test_stream_packets_and_recording(tmp_path):
    from xmaps_tpu_torch.io.evt_decoder import decode_file

    loop = generator.loop_frames(CFG, STREAM, 9)
    fps, dt = CFG["projector_fps"], 4166
    src = generator.PacketSource(loop, fps, dt)
    got = np.concatenate([src.packet(j) for j in range(2 * generator.loop_span(len(loop), fps)
                                                       // dt + 2)])
    want = generator.stream_events(loop, fps, 0, 2 * len(loop))
    assert np.array_equal(got[: len(want)], want)
    assert any(f["p"].min() == 0 for f in loop)  # OFF events for the polarity filter
    raw = str(tmp_path / "loop.raw")
    one = generator.stream_events(loop, fps, 0, len(loop))
    with open(raw, "wb") as f:
        f.write(generator.encode_evt3(one, CFG["rig"]["camera_width"], CFG["rig"]["camera_height"]))
    dec = decode_file(raw)
    assert np.array_equal(dec, one)
