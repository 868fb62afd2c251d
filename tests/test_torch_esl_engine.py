"""ESL's pseudo-ground truth on the port's path: ``ESLDepthEngine`` on the CPU.

At a small ESL rig (a 96x72 camera, a 45x80 projector rectified at 3x,
planes at 30-35 units), with scans made by the benchmark's own generator
(``benchmark/kinds/scans.py``) from seeds:

- ``process_scans`` against the plain reference (``benchmark/reference/esl.py``)
  under the ``esl-gt-scan-groups`` cell's three counts, every one 0, and
  the reference's bfloat16 control failing them;
- each scan of a group bit-equal to the one-scan path the evaluation ran
  before the engine (``build_device_depth_init`` -> ``depth_optimization_dense``
  -> ``bilateral_filter`` -> ``tv_denoise_split_bregman``), and the brute
  force init equal to kernels A and B's;
- the stacked filters bit-equal slice by slice to their 2-D calls;
- the cell's run on the CPU: its result line correct, a planted fault (one
  refined pixel moved) not;
- the CLI across group boundaries, and the reference's imports.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import harness  # noqa: E402
from benchmark.kinds import scans as scan_kind  # noqa: E402
from benchmark.reference import esl as ref_esl  # noqa: E402
from xmaps_tpu_torch.apps import eval_esl  # noqa: E402
from xmaps_tpu_torch.calib.maps import CalibrationParams, CamProjMaps  # noqa: E402
from xmaps_tpu_torch.models import esl_pipeline  # noqa: E402
from xmaps_tpu_torch.models.esl_pipeline import GROUP_SCANS, ESLDepthEngine  # noqa: E402
from xmaps_tpu_torch.ops.esl_denoise import bilateral_filter, tv_denoise_split_bregman  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CELL = "esl-gt-scan-groups"
SEEDS = (2**31 + 5, 2**31 + 6, 7)
PLANES = ("disparity_init", "depth_init", "depth_optim", "depth_optim_filtered")


def tiny_config() -> dict:
    """The ``esl-gt`` configuration at a small rig: the ESL tests' synthetic
    calibration, its planes at 30-35 units."""
    c = make_synthetic_calibration(baseline=3.0, camera_width=96, camera_height=72,
                                   projector_width=45, projector_height=80)
    cfg = json.loads((REPO / "benchmark" / "configs" / "esl_gt.json").read_text())
    cfg["rig"] = dict(
        camera_width=96, camera_height=72, projector_width=45, projector_height=80,
        rect_width=135, rect_height=240, camera_K=c.camera_K.tolist(),
        camera_D=np.asarray(c.camera_D).ravel().tolist(), projector_K=c.projector_K.tolist(),
        projector_D=np.asarray(c.projector_D).ravel().tolist(),
        cam2proj_R=c.cam2proj_R.tolist(), cam2proj_T=c.cam2proj_T.tolist())
    cfg["scene"] = {**cfg["scene"], "depth_m": [30.0, 35.0]}
    return cfg


def calibration(rig) -> CalibrationParams:
    return CalibrationParams(
        camera_width=rig["camera_width"], camera_height=rig["camera_height"],
        projector_width=rig["projector_width"], projector_height=rig["projector_height"],
        rect_image_width=rig["rect_width"], rect_image_height=rig["rect_height"],
        camera_K=np.array(rig["camera_K"]), camera_D=np.array(rig["camera_D"]),
        projector_K=np.array(rig["projector_K"]), projector_D=np.array(rig["projector_D"]),
        cam2proj_R=np.array(rig["cam2proj_R"]), cam2proj_T=np.array(rig["cam2proj_T"]))


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def engine(cfg):
    return ESLDepthEngine.from_calibration(calibration(cfg["rig"]), "cpu")


@pytest.fixture(scope="module")
def reference(cfg):
    return ref_esl.Reference(ref_esl.tables(cfg["rig"]), "cpu", cfg)


def make_scans(cfg, n, seed):
    return scan_kind.make_scans(cfg, {"groups": 1, "scans_per_group": n}, seed)


def per_scan_planes(engine, scan) -> dict:
    """The evaluation's one-scan path before the engine."""
    cam = esl_pipeline.normalize_scan(scan)
    init = esl_pipeline.build_device_depth_init(engine.maps, engine.maps.calib, engine.proj_rect,
                                            engine.p03, "cpu")
    disp, depth = init(torch.from_numpy(cam))
    img = cam.copy()
    with np.errstate(divide="ignore"):
        img[img == 0] = 1.0 / cam[0, 0] if cam[0, 0] != 0 else np.inf
    optim = esl_pipeline.depth_optimization_dense(depth, torch.from_numpy(img), engine.plan)
    filtered = tv_denoise_split_bregman(
        bilateral_filter(optim, d=5, sigma_color=3.0, sigma_space=3.0), mu=0.5)
    return dict(zip(PLANES, (disp, depth, optim, filtered)))


def assert_bits_equal(got, want, msg=""):
    got, want = np.ascontiguousarray(got, np.float32), np.ascontiguousarray(want, np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=msg)


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_process_scans_matches_reference(cfg, engine, reference, n, seed):
    scans = make_scans(cfg, n, seed)
    planes = engine.process_scans(scans)
    assert all(getattr(planes, k).shape == (n, 72, 96) for k in PLANES)
    total = dict.fromkeys(scan_kind.COUNTS.values(), 0)
    for f, scan in enumerate(scans):
        want = {k: v.numpy() for k, v in reference.planes(scan).items()}
        got = {k: getattr(planes, k)[f].numpy() for k in PLANES}
        for k, v in scan_kind.counts(got, want).items():
            total[k] += v
        init, optim = got["depth_init"], got["depth_optim"]
        assert 28 < np.median(init[init > 0]) < 37  # a plane between 30 and 35
        assert (optim > 0).sum() > 500 and (optim != init).any()
    assert total == {"init_pixels_off": 0, "refined_pixels_off": 0, "filtered_pixels_off": 0}


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_control_fails(cfg, reference, seed):
    scan = make_scans(cfg, 1, seed)[0]
    want = {k: v.numpy() for k, v in reference.planes(scan).items()}
    lower = {k: v.numpy() for k, v in reference.planes(scan, lower=True).items()}
    off = scan_kind.counts(lower, want)
    assert off["init_pixels_off"] == 0  # the control touches the refinement and filters only
    assert off["refined_pixels_off"] > 100 and off["filtered_pixels_off"] > 100


@pytest.mark.parametrize("seed", SEEDS)
def test_group_bit_equal_to_per_scan_path(cfg, engine, seed):
    scans = make_scans(cfg, 5, seed)
    planes = engine.process_scans(scans)
    for f, scan in enumerate(scans):
        want = per_scan_planes(engine, scan)
        for k in PLANES:
            assert_bits_equal(getattr(planes, k)[f].numpy(), want[k].numpy(), f"{k} scan {f}")


def test_brute_force_init_and_skip_refine(cfg, engine):
    brute = ESLDepthEngine.from_calibration(calibration(cfg["rig"]), "cpu", fast_search=False)
    assert engine.fast_search and not brute.fast_search
    scans = make_scans(cfg, 3, 11)
    fast = engine.process_scans(scans)
    slow = brute.process_scans(scans, refine=False)
    assert slow.depth_optim is None and slow.depth_optim_filtered is None
    for k in ("disparity_init", "depth_init"):
        assert_bits_equal(slow[PLANES.index(k)].numpy(), getattr(fast, k).numpy(), k)
    assert (fast.disparity_init > 0).sum() > 1000


def test_groups_grow_and_bad_scans_raise(cfg, engine):
    scans = make_scans(cfg, GROUP_SCANS + 1, 12)  # more than the staging buffer holds
    planes = engine.process_scans(scans)
    one = engine.process_scans(scans[-1:])
    for k in PLANES:
        assert_bits_equal(getattr(planes, k)[-1].numpy(), getattr(one, k)[0].numpy(), k)
    with pytest.raises(ValueError, match="empty"):
        engine.process_scans([scans[0], np.zeros_like(scans[0])])
    with pytest.raises(ValueError, match="camera"):
        engine.process_scans([scans[0][:10]])
    with pytest.raises(ValueError, match="no scans"):
        engine.process_scans([])


@pytest.mark.parametrize("fn", ["bilateral", "tv"])
def test_stacked_filters_bit_equal_per_slice(fn):
    rng = np.random.default_rng(3)
    stack = (30 + rng.standard_normal((4, 40, 56))).astype(np.float32)
    stack[:, 10:20, 5:15] = 0
    f = {"bilateral": lambda x: bilateral_filter(x, d=5, sigma_color=3.0, sigma_space=3.0),
         "tv": lambda x: tv_denoise_split_bregman(x, mu=0.5)}[fn]
    got = f(torch.from_numpy(stack))
    assert got.shape == stack.shape
    for i in range(len(stack)):
        assert_bits_equal(got[i].numpy(), f(torch.from_numpy(stack[i])).numpy(), f"slice {i}")


# -- the cell on the CPU ---------------------------------------------------------------

#: the cell run through the harness on the tiny configuration, in a process
#: of its own (the harness refuses a process that holds JAX, as this one does);
#: FAULT moves one refined pixel of every call's first scan
RUN_CELL = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from benchmark import harness
from xmaps_tpu_torch.models.esl_pipeline import ESLDepthEngine
spec, root, cache, fault = json.loads(sys.argv[1])
if fault:
    orig = ESLDepthEngine.process_scans
    def moved(self, *a, **kw):
        planes = orig(self, *a, **kw)
        y, x = np.argwhere(planes.depth_optim[0].numpy() > 0)[0]
        planes.depth_optim[0, y, x] += 0.5
        return planes
    ESLDepthEngine.process_scans = moved
out = harness.run_cell(spec, "esl-gt-scan-groups", 2**31 + 4321, 1.0, False, "cpu", root=root,
                       cache_dir=cache)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cell_root(tmp_path_factory, cfg):
    """A checkout-shaped directory holding the tiny configuration and the
    cell's traffic, shortened, and the specification pointing at them."""
    root = tmp_path_factory.mktemp("esl_cell")
    (root / "configs").mkdir()
    (root / "benchmark" / "traffic").mkdir(parents=True)
    (root / "configs" / "esl_gt.json").write_text(json.dumps(cfg))
    tr = json.loads((REPO / "benchmark" / "traffic" / "scan_groups.json").read_text())
    tr.update(scans_per_group=3, groups=2, warmup_s=0.2)
    (root / "benchmark" / "traffic" / "scan_groups.json").write_text(json.dumps(tr))
    spec = harness.load_spec()
    spec = {**spec, "configs": [{**c, "file": "configs/esl_gt.json"} for c in spec["configs"]]}
    return spec, str(root)


def run_cell(cell_root, tmp_path, fault=False) -> dict:
    spec, root = cell_root
    arg = json.dumps([spec, root, str(tmp_path), fault])
    proc = subprocess.run([sys.executable, "-c", RUN_CELL, arg], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cell_result_line(cell_root, tmp_path):
    out = run_cell(cell_root, tmp_path)
    assert out["correct"] is True and out["attempted"] >= 6 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["checks"] == {k: {"value": 0, "limit": 0} for k in
                             ("init_pixels_off", "refined_pixels_off", "filtered_pixels_off")}


def test_cell_planted_fault_is_not_correct(cell_root, tmp_path):
    out = run_cell(cell_root, tmp_path, fault=True)
    assert out["correct"] is False
    assert out["checks"]["refined_pixels_off"]["value"] > 0
    assert out["checks"]["init_pixels_off"]["value"] == 0


# -- the CLI and the reference's imports -------------------------------------------------


def test_cli_groups_bit_equal_to_one_group(cfg, tmp_path, monkeypatch):
    """``eval_esl.main`` on 5 scans (one empty, skipped) in groups of 2 and of
    12: the same files."""
    rig = cfg["rig"]
    yaml = tmp_path / "calib.yaml"
    with open(yaml, "w") as f:
        f.write("%YAML:1.0\n---\n")
        for name, key in (("cam_K", "camera_K"), ("cam_kc", "camera_D"), ("proj_K", "projector_K"),
                          ("proj_kc", "projector_D"), ("R", "cam2proj_R"), ("T", "cam2proj_T")):
            m = np.atleast_2d(np.asarray(rig[key], np.float64))
            data = ", ".join(repr(float(v)) for v in m.ravel())
            f.write(f"{name}: !!opencv-matrix\n   rows: {m.shape[0]}\n   cols: {m.shape[1]}\n"
                    f"   dt: d\n   data: [ {data} ]\n")
    scans = make_scans(cfg, 4, 21).astype(np.float64)
    outs = {}
    for group in (2, 12):
        seq = tmp_path / f"seq{group}"
        (seq / "scans_np").mkdir(parents=True)
        for i, s in enumerate([scans[0], np.zeros_like(scans[0]), *scans[1:]]):
            np.save(seq / "scans_np" / f"scan{i:03d}.npy", s)
        monkeypatch.setattr(esl_pipeline, "GROUP_SCANS", group)
        monkeypatch.setenv("HOME", str(tmp_path))
        assert eval_esl.main(["-object_dir", str(seq), "-proj_height", "80", "-proj_width", "45",
                              "-calib", str(yaml), "-num_scans", "5", "-cam_width", "96",
                              "-cam_height", "72", "-device", "cpu"]) == 0
        outs[group] = {p: sorted((seq / "esl" / p).glob("*.npy")) for p in PLANES}
    for p in PLANES:
        assert [f.name for f in outs[2][p]] == [f"scans{i:03d}.npy" for i in (0, 2, 3, 4)]
        for a, b in zip(outs[2][p], outs[12][p]):
            assert_bits_equal(np.load(a), np.load(b), str(a))


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; import benchmark.reference.esl, benchmark.kinds.scans, "
            "benchmark.roofline_esl; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'xmaps_tpu', 'xmaps_tpu_torch'}); print(bad)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def test_reference_tables_match_the_ports_maps(cfg):
    """The reference's calibration math equals the maps the engine is built
    from (rectification, the projector's time map, the refinement's rays)."""
    rig = cfg["rig"]
    tabs = ref_esl.tables(rig)
    maps = CamProjMaps(calibration(rig), zero_undistort_proj_map=True)
    np.testing.assert_array_equal(tabs["proj_rect"],
                                  maps.build_rectified_time_map(scan_upwards=False))
    assert tabs["p03"] == maps.P2[0, 3]
    plan = esl_pipeline.RefinePlan(maps.calib, maps, 7, 45, 80)
    np.testing.assert_array_equal(tabs["x_n"], plan.x_n)
    np.testing.assert_array_equal(tabs["y_n"], plan.y_n)
