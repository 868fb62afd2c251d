"""Kernel F's contract on the CPU: its priority model, the group entry's
plain version and the wrapper's input checks, against the JAX package's
``apply_frame_filter``.

Kernel F (``xmaps_tpu_torch/csrc/filters.cu``) runs only on the card, so
here its priority is modelled in plain torch (``survivor_rank``: the
bitmap over raw key + size it sets, prefix-counted) and held against the
dense rank of the JAX package and the port's plain version: over the
survivors the two must order every pair alike, and the model stays below
the capacity.  The lanes are made with numpy from a seed: collisions,
padding, polarities {-1, 0, 1}, events outside the camera
(``utils.synthetic.with_events_outside_camera``) and raw keys -1, n_keys
and below -n_keys, at a 96x72 camera and at the demonstrator's key sizes,
and an empty frame.  Every comparison with JAX is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xmaps_tpu.ops.event_batch import EventBatch as JBatch  # noqa: E402
from xmaps_tpu.ops.filters import apply_frame_filter as j_filter  # noqa: E402

from xmaps_tpu_torch.io.evt_decoder import EVENT_DTYPE  # noqa: E402
from xmaps_tpu_torch.ops.disparity import rectify_events  # noqa: E402
from xmaps_tpu_torch.ops.event_batch import EventBatch  # noqa: E402
from xmaps_tpu_torch.ops.filters import (  # noqa: E402
    FILTER_NAMES,
    MAX_GROUP_FRAMES,
    apply_frame_filter,
    apply_frame_filter_group,
    apply_frame_filter_group_plain,
    check_filter_lanes,
    lut_rectified_x,
)
from xmaps_tpu_torch.ops.scatter import MAX_CAPACITY  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import with_events_outside_camera  # noqa: E402

torch.set_num_threads(1)

#: (camera_width, camera_height, rect_width): a small rig and the
#: demonstrator's key sizes (xy 307,200 keys; first_per_yt 844,800)
RIGS = {"96x72": (96, 72, 200), "demonstrator": (640, 480, 1760)}
CAPACITY = 4096
DEDUP = FILTER_NAMES[1:]


def _lanes(rig, seed, n, *, weird=True):
    """One padded frame's lanes (numpy, int32 / bool) with ``n`` valid
    lanes: events in a corner of the camera (keys collide) and outside it,
    and, with ``weird``, lanes whose raw key is -1, n_keys and below
    -n_keys in both key spaces; and a packed camera LUT whose x passes both
    edges of the rectified width."""
    cw, ch, rw = RIGS[rig]
    rng = np.random.default_rng(seed)
    ev = np.zeros(max(n - 120, 0), dtype=EVENT_DTYPE)
    ev["x"] = rng.integers(0, min(cw, 48), len(ev))
    ev["y"] = rng.integers(0, min(ch, 36), len(ev))
    ev["p"] = rng.choice([-1, 0, 1, 1], len(ev))
    ev["t"] = np.sort(rng.integers(0, 16_000, len(ev)))
    if n:
        ev = with_events_outside_camera(ev, rng, cw, ch)
    x = np.zeros(CAPACITY, np.int32)
    y = np.zeros(CAPACITY, np.int32)
    t = np.zeros(CAPACITY, np.int32)
    p = np.zeros(CAPACITY, np.int32)
    m = min(len(ev), CAPACITY)
    x[:m], y[:m], t[:m], p[:m] = ev["x"][:m], ev["y"][:m], ev["t"][:m], ev["p"][:m]
    if weird and m:
        k = rng.choice(m, 60, replace=False)
        x[k[:15]], y[k[:15]] = -1, 0  # xy key -1
        x[k[15:30]], y[k[15:30]] = 0, ch  # key n_keys (the LUT's x at (ch - 1, 0) <= 0)
        x[k[30:45]], y[k[30:45]] = cw - 1, -1  # key -1 (the LUT's x at (0, cw - 1) past the edge)
        y[k[45:]] = -ch - 2  # below -n_keys in both key spaces
        p[k] = 1
    valid = np.zeros(CAPACITY, bool)
    valid[:m] = True
    mapx = rng.integers(-10, rw + 10, (ch, cw)).astype(np.int32)
    mapx[ch - 1, 0], mapx[0, cw - 1] = -4, rw + 3
    mapy = rng.integers(0, 50, (ch, cw)).astype(np.int32)
    lut = (mapy << 16) | (mapx & 0xFFFF)
    return (x, y, t, p, valid), lut


def _np_x_rect(x, y, lut):
    """``rectify_events``' x in numpy, from the packed LUT."""
    h, w = lut.shape
    v = lut[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)]
    return (v & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int32)


def _jax(lanes, x_rect, name, rig):
    cw, ch, rw = RIGS[rig]
    x, y, t, p, valid = lanes
    jb = JBatch(*(jnp.asarray(a) for a in lanes), count=jnp.int32(valid.sum()))
    return j_filter(jb, jnp.asarray(x_rect), name=name, camera_width=cw, camera_height=ch,
                    rect_width=rw)


def _raw_key(lanes, x_rect, name, rig):
    """The raw int32 key a dedup filter ranks by (int32 arithmetic)."""
    cw, _, rw = RIGS[rig]
    x, y = lanes[0].astype(np.int64), lanes[1].astype(np.int64)
    if name == "first_per_yt":
        key = y * rw + np.clip(x_rect, 0, rw - 1)
    else:
        key = y * cw + x
    return torch.from_numpy(key.astype(np.int32))


def survivor_rank(key: torch.Tensor, keep: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Plain model of kernel F's priority: a bitmap over raw key + size
    (size = n_keys + 1; a survivor's raw key lies in [-size, size)) with a
    bit for each survivor, prefix-counted; each survivor's rank is the
    count of bits below its own, a dropped lane's 0."""
    size = n_keys + 1
    b = key.long() + size
    assert bool(((b >= 0) & (b < 2 * size))[keep].all())
    bits = torch.zeros(2 * size, dtype=torch.int32)
    bits[b[keep]] = 1
    below = torch.cumsum(bits, 0) - bits
    return torch.where(keep, below[b.clamp(0, 2 * size - 1)], 0).int()


def _order(a: torch.Tensor) -> torch.Tensor:
    return torch.argsort(a, stable=True)


@pytest.mark.parametrize("case", ["events", "padded", "empty"])
@pytest.mark.parametrize("rig", sorted(RIGS))
@pytest.mark.parametrize("name", DEDUP)
def test_survivor_rank_orders_survivors_as_the_dense_rank(name, rig, case):
    """The model of kernel F's priority against JAX's (and the port's
    plain) dense rank over the survivors: the same order, distinct values
    below the capacity; and the survivors' raw keys distinct."""
    n = {"events": CAPACITY + 500, "padded": 1500, "empty": 0}[case]
    lanes, lut = _lanes(rig, len(name) + len(rig) + n, n)
    x_rect = _np_x_rect(lanes[0], lanes[1], lut)
    want = _jax(lanes, x_rect, name, rig)
    cw, ch, rw = RIGS[rig]
    got = apply_frame_filter(EventBatch(*(torch.from_numpy(a) for a in lanes),
                                        count=torch.tensor(int(lanes[4].sum()))),
                             None, name=name, camera_width=cw, camera_height=ch,
                             rect_width=rw, cam_lut=torch.from_numpy(lut))
    keep = got.batch.valid
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want.batch.valid))
    np.testing.assert_array_equal(got.batch.t.numpy(), np.asarray(want.batch.t))
    np.testing.assert_array_equal(got.scatter_priority.numpy(),
                                  np.asarray(want.scatter_priority))
    key = _raw_key(lanes, x_rect, name, rig)
    n_keys = ch * (rw if name == "first_per_yt" else cw)
    model = survivor_rank(key, keep, n_keys)
    dense = torch.from_numpy(np.array(want.scatter_priority))
    assert torch.equal(_order(model[keep]), _order(dense[keep]))
    assert torch.equal(torch.sort(model[keep]).values, torch.arange(int(keep.sum()),
                                                                    dtype=torch.int32))
    assert len(torch.unique(key[keep])) == int(keep.sum())
    assert int(model.max()) < CAPACITY
    if case == "empty":
        assert int(keep.sum()) == 0
    else:
        assert int(keep.sum()) > 50
        # the traps reach the survivors: a raw key of -1 or n_keys survives
        # where its slot's first (last) lane is one
        assert bool(((key == -1) | (key == n_keys))[keep].any())


@pytest.mark.parametrize("frames", [1, 5])
@pytest.mark.parametrize("name", FILTER_NAMES)
def test_group_plain_matches_jax_frame_by_frame(name, frames):
    """``apply_frame_filter_group`` on the CPU (its plain version) over a
    stacked batch, first_per_yt's x from the packed LUT, against JAX's
    ``apply_frame_filter`` of each frame with ``rectify_events``' x:
    exact, the priority too (the plain dense rank)."""
    rig = "96x72"
    cw, ch, rw = RIGS[rig]
    cases = [_lanes(rig, 31 * f + len(name), n)
             for f, n in zip(range(frames), (1800, 0, CAPACITY + 200, 900, 3000))]
    lut = cases[0][1]
    stacked = [np.stack([c[0][i] for c in cases]) for i in range(5)]
    batch = EventBatch(*(torch.from_numpy(a) for a in stacked),
                       count=torch.from_numpy(stacked[4].sum(1).astype(np.int32)))
    kw = dict(name=name, camera_width=cw, camera_height=ch, rect_width=rw)
    got = apply_frame_filter_group(batch, None, cam_lut=torch.from_numpy(lut), **kw)
    assert got.scatter_priority.shape == (frames, CAPACITY)
    assert got.batch.count.shape == (frames,)
    for f, (lanes, _) in enumerate(cases):
        want = _jax(lanes, _np_x_rect(lanes[0], lanes[1], lut), name, rig)
        for field in ("x", "y", "t", "p", "valid"):
            np.testing.assert_array_equal(getattr(got.batch, field)[f].numpy(),
                                          np.asarray(getattr(want.batch, field)),
                                          err_msg=f"frame {f} {field}")
        np.testing.assert_array_equal(got.scatter_priority[f].numpy(),
                                      np.asarray(want.scatter_priority))
    xr = lut_rectified_x(batch.x, batch.y, torch.from_numpy(lut))
    again = apply_frame_filter_group_plain(batch, xr, **kw)
    for a, b in zip((*got.batch, got.scatter_priority), (*again.batch, again.scatter_priority)):
        assert torch.equal(a, b)


def test_lut_rectified_x_is_rectify_events_x():
    """The LUT's x (kernel F's read) equals ``rectify_events``' gather of
    the int16 map, clamping pixels outside the camera."""
    rng = np.random.default_rng(4)
    mapx = rng.integers(-2**15, 2**15, (72, 96)).astype(np.int16)
    mapy = rng.integers(-2**15, 2**15, (72, 96)).astype(np.int16)
    packed = (mapy.astype(np.int32) << 16) | (mapx.astype(np.int32) & 0xFFFF)
    x = torch.from_numpy(rng.integers(-50, 150, 5000).astype(np.int32))
    y = torch.from_numpy(rng.integers(-50, 130, 5000).astype(np.int32))
    want, _ = rectify_events(x, y, torch.from_numpy(mapx), torch.from_numpy(mapy))
    assert torch.equal(lut_rectified_x(x, y, torch.from_numpy(packed)), want)


def _ok_batch(shape):
    z = torch.zeros(shape, dtype=torch.int32)
    return EventBatch(z, z.clone(), z.clone(), z.clone(), z.bool(), torch.tensor(0))


@pytest.mark.parametrize("case", ["capacity", "x_dtype", "valid_dtype", "t_dtype",
                                  "not_contiguous", "shape", "frames", "no_lut", "lut_dtype"])
def test_check_filter_lanes_refuses(case):
    """Kernel F's input checks, on CPU tensors: what the kernel does not
    take raises ValueError before any launch."""
    lut = torch.zeros((4, 5), dtype=torch.int32)
    b, name = _ok_batch((2, 64)), "first_per_xy"
    if case == "capacity":
        b = _ok_batch((MAX_CAPACITY + 1,))
    elif case == "x_dtype":
        b = b._replace(x=b.x.long())
    elif case == "valid_dtype":
        b = b._replace(valid=b.valid.int())
    elif case == "t_dtype":
        b = b._replace(t=b.t.double())
    elif case == "not_contiguous":
        b = b._replace(y=torch.zeros((64, 2), dtype=torch.int32).t())
    elif case == "shape":
        b = b._replace(p=b.p[:, :32].contiguous())
    elif case == "frames":
        b = _ok_batch((MAX_GROUP_FRAMES + 1, 4))
    elif case == "no_lut":
        name, lut = "first_per_yt", None
    else:
        name, lut = "first_per_yt", lut.long()
    with pytest.raises(ValueError, match="kernel F"):
        check_filter_lanes(b, name, lut)


def test_check_filter_lanes_takes_the_main_path():
    """Every batch the main path hands kernel F passes the checks: a frame
    and a group at the capacity limit, int32 or float32 time, with and
    without the LUT."""
    lut = torch.zeros((4, 5), dtype=torch.int32)
    for shape in ((MAX_CAPACITY,), (3, 128), (MAX_GROUP_FRAMES, 1)):
        b = _ok_batch(shape)
        for t in (b.t, b.t.float()):
            for name in DEDUP:
                check_filter_lanes(b._replace(t=t), name, lut)
        check_filter_lanes(b, "first_per_xy", None)
