"""Kernel S (``xmaps_tpu_torch.ops.store_loop``, the port of the scatter-store
micro-benchmark's TPU kernel) on the CPU, and its benchmark app.

The plain version of ``tile_store_last`` is held bit for bit against
``kernel_rowcol`` (``eval/bench_store_loop.py:52-83``, its body copied
here) run by ``pl.pallas_call`` in interpret mode, and against a
sequential NumPy loop, on draws with heavy collisions.  Then the benchmark
app's JSON line on the CPU, the wrapper's refusal of other devices, and the
kernel build (one ``nvcc`` a source, started together; a failed compile
raises) with a stand-in ``nvcc``.  Every comparison is exact.
"""

import functools
import json
import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from xmaps_tpu_torch.apps import bench_store_loop  # noqa: E402
from xmaps_tpu_torch.ops import _build  # noqa: E402
from xmaps_tpu_torch.ops.store_loop import (  # noqa: E402
    BENCH_EVENTS,
    BENCH_SHAPE,
    tile_store_last,
    tile_store_last_plain,
)

torch.set_num_threads(1)


def kernel_rowcol(row_ref, col_ref, val_ref, out_ref, *, n, unroll):
    """``eval/bench_store_loop.py:52-83``: zero the tile, then per event an
    (8, 128) read-modify-write of the tile holding its cell."""
    out_ref[...] = jnp.zeros_like(out_ref)
    sub_iota = jax.lax.broadcasted_iota(jnp.int32, (8, 128), 0)
    lane_iota = jax.lax.broadcasted_iota(jnp.int32, (8, 128), 1)

    def body(i, _):
        base = i * unroll
        for u in range(unroll):
            j = base + u
            r = row_ref[j]
            c = col_ref[j]
            v = val_ref[j]
            g = pl.multiple_of((c >> 7) * 128, 128)
            rg = pl.multiple_of((r >> 3) * 8, 8)
            cur = out_ref[pl.ds(rg, 8), pl.ds(g, 128)]
            hit = (sub_iota == (r & 7)) & (lane_iota == (c & 127))
            out_ref[pl.ds(rg, 8), pl.ds(g, 128)] = jnp.where(hit, jnp.uint32(v), cur)
        return 0

    jax.lax.fori_loop(0, n // unroll, body, 0)


def _pallas_rowcol(rows, cols, vals, shape, unroll):
    fn = pl.pallas_call(
        functools.partial(kernel_rowcol, n=len(rows), unroll=unroll),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.uint32),
        interpret=True,
    )
    return np.asarray(fn(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals)))


def _draws(n, shape, col_span, seed):
    """The JAX benchmark's draws, with the columns squeezed into
    ``col_span`` so that many events hit the same cell."""
    H, W = shape
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, H, n).astype(np.int32)
    cols = rng.integers(0, min(W, col_span), n).astype(np.int32)
    vals = rng.integers(1, 1 << 30, n).astype(np.uint32)
    return rows, cols, vals


def _numpy_loop(rows, cols, vals, shape):
    out = np.zeros(shape, np.uint32)
    for r, c, v in zip(rows, cols, vals):
        if 0 <= r < shape[0] and 0 <= c < shape[1]:
            out[r, c] = v
    return out


def _plain(rows, cols, vals, shape):
    got = tile_store_last(torch.from_numpy(rows), torch.from_numpy(cols),
                          torch.from_numpy(vals.view(np.int32)), shape)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    return got.numpy().view(np.uint32)


@pytest.mark.parametrize("n,shape,unroll,col_span", [
    (256, (16, 256), 1, 256),  # the issue's check size
    (512, (8, 128), 4, 12),  # ~5 events a cell
    (384, (16, 384), 8, 130),  # a cell range across a 128-lane group edge
], ids=["sparse", "collisions", "lane_edge"])
def test_plain_matches_pallas_interpret(n, shape, unroll, col_span):
    rows, cols, vals = _draws(n, shape, col_span, seed=n)
    got = _plain(rows, cols, vals, shape)
    np.testing.assert_array_equal(got, _pallas_rowcol(rows, cols, vals, shape, unroll))
    np.testing.assert_array_equal(got, _numpy_loop(rows, cols, vals, shape))
    cells = rows.astype(np.int64) * shape[1] + cols
    assert (got != 0).sum() == len(np.unique(cells))


def test_plain_at_bench_shape_matches_numpy_loop():
    """The benchmark's own draws (seed 0, 28672 events into 64 x 1152),
    the high bit of the values set on half of them, and events outside the
    tile (dropped)."""
    rows, cols, vals = (t.numpy() for t in bench_store_loop.make_inputs(BENCH_EVENTS, BENCH_SHAPE))
    rows, cols, vals = rows.copy(), cols.copy(), vals.copy().view(np.uint32)
    vals[::2] |= np.uint32(1 << 31)
    rows[::97] = -1
    cols[::89] = BENCH_SHAPE[1]
    np.testing.assert_array_equal(_plain(rows, cols, vals, BENCH_SHAPE),
                                  _numpy_loop(rows, cols, vals, BENCH_SHAPE))


def test_plain_without_events_is_zero():
    empty = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(tile_store_last(empty, empty, empty, (8, 128)),
                       torch.zeros((8, 128), dtype=torch.int32))


def test_bench_app_prints_one_json_line(capsys):
    """The benchmark's own size (28672 events into 64 x 1152) on the CPU."""
    assert bench_store_loop.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["metric"] == "ns_per_store" and result["device"] == "cpu"
    assert result["events"] == BENCH_EVENTS and result["shape"] == list(BENCH_SHAPE)
    assert result["iters"] == bench_store_loop.ITERS
    assert result["gpu"] is None and result["library_equal"] is True
    for k in ("kernel", "plain", "library"):
        assert len(result[f"{k}_turns_ms"]) == 2 and min(result[f"{k}_turns_ms"]) > 0
        assert result[f"{k}_ms"] == pytest.approx(sum(result[f"{k}_turns_ms"]) / 2)
        assert result[f"{k}_ns_per_store"] == pytest.approx(result[f"{k}_ms"] * 1e6 / BENCH_EVENTS)


def test_bench_app_refuses_cuda_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench_store_loop.main([])


def test_wrapper_refuses_other_devices():
    meta = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tile_store_last(meta, meta, meta, (8, 128))


_FAKE_NVCC = """#!/bin/sh
# stand-in nvcc: log the call, write the -o file, fail on a marked source
echo "$@" >> "{log}"
case "$*" in *{bad}*) echo "error: {bad}" ; exit 3 ;; esac
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi
  shift
done
"""


@pytest.mark.parametrize("bad", ["none", "store_loop.cu"])
def test_build_compiles_each_source_then_links(tmp_path, monkeypatch, bad):
    """One nvcc call a source (``-c``), then one link of the objects; a
    failed compile raises with nvcc's output and links nothing."""
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(_FAKE_NVCC.format(log=log, bad=bad))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("XMAPS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    if bad == "none":
        # the stand-in library is no shared object: loading it fails
        with pytest.raises(OSError):
            _build.load()
        assert len(list((tmp_path / "build").glob("libxmaps_kernels_*.so"))) == 1
    else:
        with pytest.raises(RuntimeError, match="(?s)nvcc failed.*error: store_loop.cu"):
            _build.load()
        assert not list((tmp_path / "build").glob("*.so"))
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) == sorted(_build.SOURCES)
    links = [c for c in calls if "-shared" in c.split()]
    assert len(links) == (1 if bad == "none" else 0)
    assert len(calls) == len(compiles) + len(links)
    assert list((tmp_path / "build").iterdir()) == (
        list((tmp_path / "build").glob("*.so")))  # no temporary left behind
