"""The port's offline evaluation chain vs the JAX package's.

The four apps of each package (ESL init + refine, MC3D, X-maps, table) run
on the synthetic sequence of ``tests/test_eval.py::test_full_eval_chain``
(the port with ``-device cpu``: the kernels' plain versions), and their
outputs are compared file for file:

- ESL ``disparity_init`` / ``depth_init``, MC3D depth, X-maps depth and
  point clouds: exact;
- ESL ``depth_optim`` (the refinement): XLA on the CPU contracts the cost's
  multiply-adds into FMAs where PyTorch rounds each operation, which can
  move a grid search to a neighbouring sample.  Tolerance: the same
  defined pixels, at most 2% of the pixels differ, and each refined depth
  stays inside its search bounds depth0 +- depth0^2/p03 (so the two differ
  by at most twice that radius); on this sequence 2 and 32 of 6912 pixels
  differ;
- ESL ``depth_optim_filtered``: the same tolerance as
  ``tests/test_torch_denoise.py`` (absolute 1e-4) where both filter the
  same refined depths, and the refinement's differences smoothed
  otherwise: absolute 0.1 in depth units of ~30, median difference below
  1e-5;
- the table: the same rows, character for character.

Also: the static tables each package builds from the calibration, MC3D
and the refinement as functions (with a reprojection that blows up past
the int32 range), the event-capacity repair against the JAX engine, the
CLI's device rules, and that the port's eval apps run without JAX.
"""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_eval import _write_esl_yaml  # noqa: E402
from xmaps_tpu.apps import eval_esl as jesl  # noqa: E402
from xmaps_tpu.apps import eval_mc3d as jmc3d  # noqa: E402
from xmaps_tpu.apps import eval_table as jtable  # noqa: E402
from xmaps_tpu.apps import eval_xmaps as jxmaps  # noqa: E402
from xmaps_tpu.calib.maps import CalibrationParams as JCalib  # noqa: E402
from xmaps_tpu.calib.maps import CamProjMaps as JMaps  # noqa: E402
from xmaps_tpu.models.depth_pipeline import XMapsDepthEngine as JEngine  # noqa: E402
from xmaps_tpu.ops.disparity import compute_event_disparity as j_ced  # noqa: E402
from xmaps_tpu.ops.event_batch import EventBatch as JBatch  # noqa: E402
from xmaps_tpu.ops.scatter import scatter_disp_packed as j_scatter  # noqa: E402
from xmaps_tpu.utils.ply import read_ply  # noqa: E402
from xmaps_tpu.utils.synthetic import (  # noqa: E402
    make_synthetic_calibration,
    simulate_plane_events,
)

from xmaps_tpu_torch.apps import eval_esl as tesl  # noqa: E402
from xmaps_tpu_torch.apps import eval_mc3d as tmc3d  # noqa: E402
from xmaps_tpu_torch.apps import eval_table as ttable  # noqa: E402
from xmaps_tpu_torch.apps import eval_xmaps as txmaps  # noqa: E402
from xmaps_tpu_torch.calib.maps import CalibrationParams as TCalib  # noqa: E402
from xmaps_tpu_torch.calib.maps import CamProjMaps as TMaps  # noqa: E402
from xmaps_tpu_torch.models import esl_pipeline as tpipe  # noqa: E402
from xmaps_tpu_torch.models.depth_pipeline import XMapsDepthEngine as TEngine  # noqa: E402
from xmaps_tpu_torch.ops.cuda_events import event_disparity_scatter  # noqa: E402
from xmaps_tpu_torch.ops.disparity import scale_time  # noqa: E402
from xmaps_tpu_torch.ops.esl_refine import to_int32_saturating  # noqa: E402
from xmaps_tpu_torch.ops.event_batch import EventBatch as TBatch  # noqa: E402
from xmaps_tpu_torch.ops.scatter import PACK  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SIZES = dict(camera_width=96, camera_height=72, projector_width=45, projector_height=80)
DEPTHS = (30.0, 35.0)


def _write_sequence(root, calib):
    seq = root / "seq1"
    (seq / "scans_np").mkdir(parents=True)
    for i, z in enumerate(DEPTHS):
        ev = simulate_plane_events(calib, depth_m=z, scan_upwards=False)
        img = np.zeros((calib.camera_height, calib.camera_width), np.float64)
        img[ev["y"], ev["x"]] = (ev["t"] + 1) / (ev["t"].max() + 1)
        np.save(seq / "scans_np" / f"scan{i:03d}.npy", img)
    return seq


def _args(seq, yaml_path):
    return [
        "-object_dir", str(seq),
        "-proj_height", str(SIZES["projector_height"]),
        "-proj_width", str(SIZES["projector_width"]),
        "-calib", yaml_path,
        "-num_scans", str(len(DEPTHS)),
        "-cam_width", str(SIZES["camera_width"]),
        "-cam_height", str(SIZES["camera_height"]),
    ]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both packages' apps on the same sequence, once per module: the JAX
    chain under jax/, the port's under torch/, and the port's ESL with
    -skip_refine and with -no_fast_search beside it."""
    root = tmp_path_factory.mktemp("eval_chain")
    calib = make_synthetic_calibration(baseline=3.0, **SIZES)
    yaml_path = str(root / "calib.yaml")
    _write_esl_yaml(yaml_path, calib)
    seqs = {name: _write_sequence(root / name, calib)
            for name in ("jax", "torch", "skip_refine", "no_fast_search")}
    cpu = ["-device", "cpu"]
    quiet = contextlib.redirect_stdout(io.StringIO())
    with quiet:
        for j, t in ((jesl, tesl), (jmc3d, tmc3d), (jxmaps, txmaps)):
            assert j.main(_args(seqs["jax"], yaml_path)) == 0
            assert t.main(_args(seqs["torch"], yaml_path) + cpu) == 0
        assert tesl.main(_args(seqs["skip_refine"], yaml_path) + cpu + ["-skip_refine"]) == 0
        assert tesl.main(_args(seqs["no_fast_search"], yaml_path) + cpu + ["-no_fast_search"]) == 0
    return seqs, yaml_path


def _load(seq, sub, i):
    return np.load(seq / sub / f"scans{i:03d}.npy")


@pytest.mark.parametrize("sub", ["esl/disparity_init", "esl/depth_init", "mc3d/depth",
                                 "x_maps/depth_init"])
def test_chain_init_outputs_bit_equal(chain, sub):
    seqs, _ = chain
    for i, z in enumerate(DEPTHS):
        want = _load(seqs["jax"], sub, i)
        got = _load(seqs["torch"], sub, i)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"{sub} scan {i}")
        if "depth" in sub:  # a plausible plane depth, not a vacuous match
            nz = got[got > 0]
            assert len(nz) > 100 and abs(np.median(nz) - z) < 2.0, (sub, np.median(nz))


def test_chain_point_clouds_bit_equal(chain):
    seqs, _ = chain
    for i in range(len(DEPTHS)):
        sub = Path("x_maps/pointcloud_init") / f"scans{i:03d}.ply"
        want = read_ply(str(seqs["jax"] / sub))
        assert len(want) > 200
        np.testing.assert_array_equal(read_ply(str(seqs["torch"] / sub)), want)


def _refine_radius(depth_init, p03):
    return depth_init.astype(np.float64) ** 2 / p03


def _p03(yaml_path):
    calib = TCalib.from_esl_yaml(yaml_path, SIZES["camera_width"], SIZES["camera_height"],
                                 SIZES["projector_width"], SIZES["projector_height"],
                                 rectification_scale=3.0)
    return float(TMaps(calib, zero_undistort_proj_map=True).P2[0, 3])


def _assert_refined_close(got, want, depth_init, p03, max_share=0.02):
    np.testing.assert_array_equal(got > 0, want > 0)
    differ = got != want
    assert differ.mean() <= max_share, differ.mean()
    bound = 2 * _refine_radius(depth_init, p03) + 1e-6
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()
    return differ


def test_chain_refined_within_tolerance(chain):
    seqs, yaml_path = chain
    p03 = _p03(yaml_path)
    for i in range(len(DEPTHS)):
        init = _load(seqs["jax"], "esl/depth_init", i)
        want = _load(seqs["jax"], "esl/depth_optim", i)
        got = _load(seqs["torch"], "esl/depth_optim", i)
        _assert_refined_close(got, want, init, p03)
        assert (want != init).any()  # the refinement moved something

        jf = _load(seqs["jax"], "esl/depth_optim_filtered", i)
        tf = _load(seqs["torch"], "esl/depth_optim_filtered", i)
        np.testing.assert_allclose(tf, jf, rtol=0, atol=0.1)
        assert np.median(np.abs(tf - jf)) < 1e-5
        # the port's filters on the JAX refinement: the filter tolerance
        from xmaps_tpu_torch.utils.denoise import bilateral_filter, tv_denoise_split_bregman

        refiltered = tv_denoise_split_bregman(
            bilateral_filter(torch.from_numpy(want), d=5, sigma_color=3.0, sigma_space=3.0),
            mu=0.5,
        )
        np.testing.assert_allclose(refiltered.numpy(), jf, rtol=0, atol=1e-4)


def test_chain_skip_refine_and_no_fast_search(chain):
    seqs, _ = chain
    for i in range(len(DEPTHS)):
        for sub in ("esl/disparity_init", "esl/depth_init"):
            want = _load(seqs["jax"], sub, i)
            for name in ("skip_refine", "no_fast_search"):
                np.testing.assert_array_equal(_load(seqs[name], sub, i), want, err_msg=name)
        for sub in ("esl/depth_optim", "esl/depth_optim_filtered"):
            np.testing.assert_array_equal(
                _load(seqs["no_fast_search"], sub, i), _load(seqs["torch"], sub, i))
    assert not list((seqs["skip_refine"] / "esl/depth_optim").glob("*.npy"))


def test_chain_table_rows_equal(chain):
    seqs, _ = chain

    def table(main, seq):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(["-object_dir", str(seq.parent), "-scenes", "seq1",
                         "-min_depth", "5", "-max_depth", "60"]) == 0
        return out.getvalue()

    want = table(jtable.main, seqs["jax"])
    for row in ("ESL (init)", "MC3D", "X-Maps (ours)"):
        assert row in want
    assert table(ttable.main, seqs["jax"]) == want
    assert table(ttable.main, seqs["torch"]) == want


# -- the static tables and the per-scan functions --------------------------------


@pytest.fixture(scope="module")
def rig(chain):
    _, yaml_path = chain
    kw = dict(camera_width=SIZES["camera_width"], camera_height=SIZES["camera_height"],
              projector_width=SIZES["projector_width"],
              projector_height=SIZES["projector_height"])
    jc = JCalib.from_esl_yaml(yaml_path, rectification_scale=3.0, **kw)
    tc = TCalib.from_esl_yaml(yaml_path, rectification_scale=3.0, **kw)
    jm = JMaps(jc, zero_undistort_proj_map=True)
    tm = TMaps(tc, zero_undistort_proj_map=True)
    return jc, tc, jm, tm


def test_static_tables_equal(rig):
    """The refinement plan and the MC3D tables each package builds from
    the calibration (the remap indices and the search's prep tables are
    pinned in test_torch_remap.py / test_torch_esl.py)."""
    jc, tc, jm, tm = rig
    Wp, Hp = SIZES["projector_width"], SIZES["projector_height"]
    jp = jesl.RefinePlan(jc, jm, 3, Wp, Hp)
    tp = tpipe.RefinePlan(tc, tm, 3, Wp, Hp)
    for name in ("x_n", "y_n", "R", "T", "proj_K", "proj_D"):
        a, b = getattr(tp, name), getattr(jp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("window_size", "w", "proj_w", "proj_h", "p03"):
        assert getattr(tp, name) == getattr(jp, name), name
    cw, ch = SIZES["camera_width"], SIZES["camera_height"]
    jt = jmc3d.build_mc3d_tables(jc, Wp, Hp, cw, ch)
    tt = tmc3d.build_mc3d_tables(tc, Wp, Hp, cw, ch)
    for a, b in zip(tt[:4], jt[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tt[4:] == jt[4:]


def test_mc3d_disparity_bit_equal(rig):
    jc, tc, _, _ = rig
    Wp, Hp = SIZES["projector_width"], SIZES["projector_height"]
    cw, ch = SIZES["camera_width"], SIZES["camera_height"]
    tables = tmc3d.build_mc3d_tables(tc, Wp, Hp, cw, ch)
    rng = np.random.default_rng(11)
    cam = rng.random((ch, cw)).astype(np.float32)
    cam[rng.random(cam.shape) < 0.2] = 0
    cam[0, :5] = [1.0, 1.5, -0.2, 2e9, np.nan]  # ids at and past the projector's end
    want = np.asarray(jmc3d.mc3d_disparity_dense(cam, tables, Wp, Hp))
    got = tmc3d.mc3d_disparity_dense(torch.from_numpy(cam), tables, Wp, Hp)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.1


def test_int32_saturating_cast_matches_xla():
    x = np.array([3e9, -3e9, np.nan, 1e20, np.inf, -np.inf, 2147483520.0,
                  -2147483648.0, 1.5, -1.5, -2.7e9, 0.0], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = to_int32_saturating(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_refinement_within_tolerance_with_blown_up_reprojection(chain, rig):
    """depth_optimization_dense on the sequence's first depth_init, plus a
    block of pixels whose first grid sample is depth 0 exactly: with a
    translation along x only and p03 = 256, depth 256 has the lower bound
    256 - 256^2/256 = 0 with or without an FMA.  There zp == 0 becomes
    1e-12 and x_proj overflows int32 while y_proj stays inside: XLA
    saturates the cast to INT32_MAX, the int32 bounds test wraps to
    "inside" and the wrapped scan time is small, so that sample competes
    with the real ones over a camera patch of early times (0.05).  The
    block's refined depths hang on those rules (a plain cast, INT32_MIN,
    changes some of them) and must equal the JAX package's exactly."""
    seqs, _ = chain
    jc, tc, jm, tm = rig
    Wp, Hp = SIZES["projector_width"], SIZES["projector_height"]
    jp = jesl.RefinePlan(jc, jm, 3, Wp, Hp)
    tp = tpipe.RefinePlan(tc, tm, 3, Wp, Hp)
    for plan in (jp, tp):
        plan.T = plan.T.copy()
        plan.T[1:] = 0.0
        plan.p03 = 256.0
    depth = _load(seqs["jax"], "esl/depth_init", 0).copy()
    block = (slice(20, 30), slice(20, 40))
    depth[block] = 256.0
    cam = tpipe.normalize_scan(np.load(seqs["jax"] / "scans_np" / "scan000.npy"))
    cam[cam == 0] = 1.0 / cam[0, 0] if cam[0, 0] != 0 else np.inf
    cam[17:33, 17:43] = 0.05
    want = np.asarray(jesl.depth_optimization_dense(depth, cam, jp))
    got = tpipe.depth_optimization_dense(torch.from_numpy(depth), torch.from_numpy(cam), tp)
    np.testing.assert_array_equal(got.numpy()[block], want[block])
    assert (want[block] == 0).any()  # the blown-up sample won some pixels...
    assert (want[block] > 0).any()  # ...and lost others
    _assert_refined_close(got.numpy(), want, depth, 256.0)


# -- the event-capacity repair ------------------------------------------------------


def test_capacity_repair_bit_equal_to_jax():
    """A camera-view frame of 300000 valid events on a 64x48 camera (many
    lanes per pixel): lanes above 262143 win their pixels, and the frame
    equals the JAX engine's process_batch_device bit for bit."""
    capacity = 307200  # the eval's 640 x 480 whole-image batch
    calib_kw = dict(camera_width=64, camera_height=48, projector_width=90, projector_height=160)
    kw = dict(event_capacity=capacity, z_near=0.2, z_far=1.2, camera_perspective=True)
    jeng = JEngine.from_calibration(make_synthetic_calibration(**calib_kw),
                                    use_pallas_tail=False, use_pallas_events=False, **kw)
    from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration as t_calib

    teng = TEngine.from_calibration(t_calib(**calib_kw), device="cpu", **kw)
    n = 300000
    rng = np.random.default_rng(9)
    x = rng.integers(0, 64, n)
    y = rng.integers(0, 48, n)
    t = rng.random(n).astype(np.float32)
    p = np.ones(n, np.int64)
    ref = jeng.process_batch_device(JBatch.from_arrays(x, y, t, p, capacity))
    batch = TBatch.from_arrays(x, y, t, p, capacity, device="cpu")
    got = teng.process_batch_device(batch)
    for name in ("frame_bgr", "depth", "disp_map"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(got.num_inliers) == int(ref.num_inliers) > 100000
    assert int(batch.count) == n > 262143

    # the packed words themselves, against the JAX package's uint32 scatter
    t_bin = scale_time(batch.t, batch.valid, teng.cfg.t_px_scale)
    packed = event_disparity_scatter(batch, t_bin, teng.tables, camera_view=True,
                                     window=(0, 0), out_shape=(48, 64)).packed_map
    jb = JBatch.from_arrays(x, y, t, p, capacity)
    res = j_ced(jb, jeng.tables.cam_mapx_i16, jeng.tables.cam_mapy_i16, jeng.tables.x_map,
                t_px_scale=jeng.cfg.t_px_scale)
    want = np.asarray(j_scatter(jb.y, jb.x, res.disp, res.inlier, height=48, width=64,
                                method="max"))
    words = packed.numpy().view(np.uint32)
    np.testing.assert_array_equal(words, want)
    winners = words[words > 0] // PACK - 1
    assert (winners > 262143).mean() > 0.9  # the high lanes won


# -- the CLI's device rules and the no-JAX import boundary ----------------------


def test_cli_device_rules(monkeypatch, chain):
    seqs, yaml_path = chain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tesl.main, tmc3d.main, txmaps.main):
        with pytest.raises(RuntimeError, match="is_available"):
            main(_args(seqs["torch"], yaml_path) + ["-device", "cuda"])
    # -devices N > 1 takes cuda:0 .. cuda:N-1: refused where they are not there
    with pytest.raises(ValueError, match="not there"):
        txmaps.main(_args(seqs["torch"], yaml_path) + ["-device", "cuda", "-devices", "2"])
    with pytest.raises(SystemExit):
        tesl.main(_args(seqs["torch"], yaml_path) + ["-device", "tpu"])


def test_eval_apps_in_subprocess_never_load_jax(tmp_path):
    code = f"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from xmaps_tpu_torch.apps import eval_esl, eval_mc3d, eval_table, eval_xmaps
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration, simulate_plane_events
calib = make_synthetic_calibration(baseline=3.0, camera_width=96, camera_height=72,
                                   projector_width=45, projector_height=80)
def mat(name, m):
    m = np.asarray(m, dtype=np.float64)
    rows, cols = m.shape[0], (m.shape[1] if m.ndim > 1 else 1)
    data = ", ".join(repr(float(v)) for v in m.ravel())
    return f"{{name}}: !!opencv-matrix\\n   rows: {{rows}}\\n   cols: {{cols}}\\n   dt: d\\n   data: [ {{data}} ]\\n"
with open("{tmp_path}/calib.yaml", "w") as f:
    f.write("%YAML:1.0\\n---\\n")
    for name, m in (("cam_K", calib.camera_K), ("cam_kc", calib.camera_D.reshape(1, -1)),
                    ("proj_K", calib.projector_K), ("proj_kc", calib.projector_D.reshape(1, -1)),
                    ("R", calib.cam2proj_R), ("T", calib.cam2proj_T)):
        f.write(mat(name, m))
import os
os.makedirs("{tmp_path}/seq1/scans_np")
ev = simulate_plane_events(calib, depth_m=30.0, scan_upwards=False)
img = np.zeros((72, 96))
img[ev["y"], ev["x"]] = (ev["t"] + 1) / (ev["t"].max() + 1)
np.save("{tmp_path}/seq1/scans_np/scan000.npy", img)
args = ["-object_dir", "{tmp_path}/seq1", "-proj_height", "80", "-proj_width", "45",
        "-calib", "{tmp_path}/calib.yaml", "-num_scans", "1", "-cam_width", "96",
        "-cam_height", "72", "-device", "cpu"]
for main in (eval_esl.main, eval_mc3d.main, eval_xmaps.main):
    assert main(args) == 0
assert eval_table.main(["-object_dir", "{tmp_path}", "-scenes", "seq1",
                        "-min_depth", "5", "-max_depth", "60"]) == 0
d = np.load("{tmp_path}/seq1/esl/depth_init/scans000.npy")
assert abs(np.median(d[d > 0]) - 30.0) < 2.0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "xmaps_tpu"))
assert not loaded, loaded
print("no-jax-ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax-ok" in proc.stdout
    assert "X-Maps (ours)" in proc.stdout
