"""ESL's refinement, kernel R's wrapper and its plain version, on the CPU.

- ``ops.esl_refine.esl_refine`` refuses what kernel R does not take (on
  either device, so the CPU run refuses the same inputs as the card), and a
  CUDA engine without a card is refused;
- the plain version (moved from ``apps.eval_esl``) on a group equals the
  benchmark's plain reference (``benchmark/reference/esl.py``) and its
  one-scan calls bit for bit;
- the constant block kernel R reads equals the plain version's float32
  roundings, in the layout the kernel's source reads it;
- kernel R's own source (``csrc/esl_refine.cu``), compiled with g++ against
  a CPU stand-in for the CUDA runtime (``tests/cuda_cpu``), equals the plain
  version bit for bit on scans, on crafted pixels (zp == 0, casts that
  saturate, projections out of bounds, depth <= 0, the region's border, an
  all-lit scan) and at every window size it takes.

The card's comparisons are in ``tests/test_torch_cuda.py`` (``-k esl_refine``).
"""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark.reference import esl as ref_esl  # noqa: E402
from test_torch_esl_engine import calibration, make_scans, tiny_config  # noqa: E402
from xmaps_tpu_torch.models import esl_pipeline  # noqa: E402
from xmaps_tpu_torch.models.esl_pipeline import ESLDepthEngine  # noqa: E402
from xmaps_tpu_torch.ops import _build  # noqa: E402
from xmaps_tpu_torch.ops import esl_refine as er  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "xmaps_tpu_torch" / "csrc" / "esl_refine.cu"
SEEDS = (2**31 + 5, 7)


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def engine(cfg):
    return ESLDepthEngine.from_calibration(calibration(cfg["rig"]), "cpu")


@pytest.fixture(scope="module")
def reference(cfg):
    return ref_esl.Reference(ref_esl.tables(cfg["rig"]), "cpu", cfg)


def group_inputs(cfg, engine, n, seed):
    """(depth0, filled camera image) of n scans, (n, H, W), as the engine
    hands them to the refinement."""
    cams = torch.from_numpy(np.stack([esl_pipeline.normalize_scan(s)
                                      for s in make_scans(cfg, n, seed)]))
    depth = torch.stack([engine.depth_init(c)[1] for c in cams])
    fill = torch.ones_like(cams[:, 0, 0]) / cams[:, 0, 0]
    return depth, torch.where(cams == 0, fill[:, None, None], cams)


def plan_of(engine, window_size, **fields):
    plan = esl_pipeline.RefinePlan(engine.maps.calib, engine.maps, window_size,
                               engine.plan.proj_w, engine.plan.proj_h)
    for k, v in fields.items():
        setattr(plan, k, v)
    return plan


def assert_bits_equal(got, want, msg=""):
    g, w = got.contiguous().numpy(), want.contiguous().numpy()
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=msg)


# -- the wrapper's refusals -------------------------------------------------------

def _refusals():
    d = torch.ones((2, 20, 30))
    return {
        "dtype": (d.double(), d, 7, 64, "float32"),
        "cam_dtype": (d, d.half(), 7, 64, "float32"),
        "not_contiguous": (d.transpose(1, 2).contiguous().transpose(1, 2), d, 7, 64,
                           "not contiguous"),
        "shapes": (d, d[:1], 7, 64, "shape"),
        "rank": (d[None], d[None], 7, 64, r"\(H, W\) or \(F, H, W\)"),
        "window": (d, d, 2 * er.MAX_W + 3, 64, "half-width"),
        "iters": (d, d, 7, 0, "iters"),
        "device": (d.to("meta"), d.to("meta"), 7, 64, "unsupported device"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrapper_refuses(engine, case):
    depth0, cam, window_size, iters, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        er.esl_refine(depth0, cam, plan_of(engine, window_size), iters)


def test_cuda_engine_without_card_is_refused(cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ESLDepthEngine.from_calibration(calibration(cfg["rig"]), "cuda")


# -- the plain version --------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_plain_group_equals_reference_and_one_scan_calls(cfg, engine, reference, seed):
    """The moved plain version on a group of 4 equals its one-scan calls,
    ``depth_optimization_dense`` and the cell's reference, scan by scan."""
    depth, img = group_inputs(cfg, engine, 4, seed)
    got = er.esl_refine(depth, img, engine.plan)
    assert _build.LAUNCHES["esl_refine"] == 0  # the CPU launches nothing
    for f in range(len(depth)):
        assert_bits_equal(got[f], er.esl_refine_plain(depth[f], img[f], engine.plan), f"{f}")
        assert_bits_equal(got[f], esl_pipeline.depth_optimization_dense(
            depth[f].numpy(), img[f].numpy(), engine.plan), f"{f}")
        want = ref_esl.refine(depth[f], img[f], reference, torch.float32,
                              **reference.settings["refine"])
        assert_bits_equal(got[f], want, f"scan {f} against the reference")
        assert (got[f] > 0).sum() > 500


# -- the constant block --------------------------------------------------------------

def _f32(v):
    return np.float32(v)


@pytest.mark.parametrize("window_size,iters", [(7, 64), (5, 50), (1, 3)])
def test_constant_block_is_the_plain_versions_roundings(engine, window_size, iters):
    plan = plan_of(engine, window_size, proj_D=np.array([-0.11, 0.07, 0.0013, -0.0021, 0.015],
                                                        np.float32))
    block = er.constant_block(plan, iters)
    w, Hp, Wp = plan.w, plan.proj_h, plan.proj_w
    assert block.dtype == np.float32 and len(block) == 32 + (2 * w + 1) ** 2
    k1, k2, p1, p2, k3 = (float(v) for v in plan.proj_D)
    inv_n = 1.0 / (Wp * Hp)
    b = [(dx * Hp + dy) * inv_n for dy in range(-w, w + 1) for dx in range(-w, w + 1)]
    B2 = 0.0
    for v in b:
        B2 += v * v
    want = dict(
        zip(("R00", "R01", "R02", "R10", "R11", "R12", "R20", "R21", "R22"), plan.R.ravel()),
        T0=plan.T[0], T1=plan.T[1], T2=plan.T[2],
        fx=plan.proj_K[0, 0], cx=plan.proj_K[0, 2], fy=plan.proj_K[1, 1], cy=plan.proj_K[1, 2],
        k1=k1, k2=k2, p1=p1, p2=p2, k3=k3, **{"2p1": 2 * p1, "2p2": 2 * p2},
        inv_n=inv_n, B2=B2, inv_p03=np.float32(1) / np.float32(plan.p03),
        inv_iters=np.float32(1) / np.float32(iters), tiny=1e-12, oob=er.OOB_COST)
    assert set(want) == set(er.CONSTANTS)
    for i, name in enumerate(er.CONSTANTS):
        assert block[i].view(np.int32) == _f32(want[name]).view(np.int32), name
    assert not block[len(er.CONSTANTS):32].any()
    np.testing.assert_array_equal(block[32:].view(np.int32),
                                  np.array(b, np.float32).view(np.int32))
    assert block[er.CONSTANTS.index("2p1")] == 2 * block[er.CONSTANTS.index("p1")]


def test_constant_block_layout_is_the_kernels():
    """The kernel's C_* offsets name the slots of CONSTANTS, its MAX_W is the
    wrapper's."""
    src = SOURCE.read_text()
    offsets = {m[0]: int(m[1]) for m in re.findall(r"\bC_(\w+) = (\d+)", src)}
    names = {"R": "R00", "T": "T0", "2P1": "2p1", "2P2": "2p2", "B2": "B2"}
    for key, at in offsets.items():
        if key == "TAPS":
            assert at == 32
            continue
        name = names.get(key, key.lower())
        assert er.CONSTANTS.index(name) == at, key
    # every name's offset (R's and T's their first), and the taps'
    assert len(offsets) == len(er.CONSTANTS) - 10 + 1
    assert re.search(r"constexpr int MAX_W = (\d+);", src)[1] == str(er.MAX_W)


def test_plan_caches_constants_per_device_and_iters(engine):
    plan = plan_of(engine, 7)
    a = plan.constants("cpu", 64)
    assert plan.constants("cpu", 64) is a
    b = plan.constants("cpu", 50)
    assert b is not a and b[er.CONSTANTS.index("inv_iters")] == np.float32(1) / np.float32(50)
    np.testing.assert_array_equal(a.numpy(), er.constant_block(plan, 64))


# -- kernel R's source on the CPU -----------------------------------------------------

@pytest.fixture(scope="module")
def kernel_r(tmp_path_factory):
    """``esl_refine`` of csrc/esl_refine.cu built with g++ against
    tests/cuda_cpu, its launch rewritten to the stand-in's."""
    src = SOURCE.read_text()
    launch = re.compile(r"(\w+)<<<(\w+), (dim3\([^)]*\)), 0, stream>>>\(")
    assert len(launch.findall(src)) == 1
    out = tmp_path_factory.mktemp("kernel_r")
    cpp = out / "esl_refine.cpp"
    cpp.write_text(launch.sub(r"cpu_launch(\2, \3, \1, ", src))
    lib = out / "libesl_refine.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{REPO / 'tests' / 'cuda_cpu'}", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).esl_refine
    fn.argtypes = _build._SIGNATURES["esl_refine"]
    fn.restype = ctypes.c_int

    def run(depth0, cam, plan, iters=64):
        xn, yn = plan.rays("cpu")
        consts = plan.constants("cpu", iters)
        F = 1 if depth0.dim() == 2 else depth0.shape[0]
        H, W = depth0.shape[-2:]
        out = torch.full_like(depth0, -7.0)  # every pixel must be written
        err = fn(depth0.data_ptr(), cam.data_ptr(), xn.data_ptr(), yn.data_ptr(),
                 consts.data_ptr(), F, H, W, plan.w, plan.window_size, plan.proj_h, plan.proj_w,
                 iters, out.data_ptr(), None)
        assert err == 0
        return out

    run.entry = fn
    return run


@pytest.mark.parametrize("window_size,iters", [(7, 64), (5, 50), (3, 64)])
def test_kernel_source_equals_plain_on_scans(cfg, engine, kernel_r, window_size, iters):
    depth, img = group_inputs(cfg, engine, 3, SEEDS[0])
    plan = plan_of(engine, window_size, proj_D=np.array([-0.11, 0.07, 0.0013, -0.0021, 0.015],
                                                        np.float32))
    got = kernel_r(depth, img, plan, iters)
    want = er.esl_refine_plain(depth, img, plan, iters)
    assert_bits_equal(got, want)
    assert (want > 0).sum() > 1000
    assert_bits_equal(kernel_r(depth[1].contiguous(), img[1].contiguous(), plan, iters), want[1])


def test_kernel_source_equals_plain_on_crafted_pixels(cfg, engine, kernel_r):
    """The projection blown up as test_torch_eval's case makes it (T along x,
    p03 = 256: depth 256's first sample is depth 0, zp == 0, x_proj beyond
    int32), huge depths (casts saturate), depth <= 0, the region's border
    lit, an all-lit scan."""
    depth, img = group_inputs(cfg, engine, 3, SEEDS[1])
    plan = plan_of(engine, 7, T=np.array([engine.plan.T[0], 0, 0], np.float32), p03=256.0)
    d = depth.clone()
    d[0, 20:30, 20:40] = 256.0
    d[0, 10, 10:14] = torch.tensor([-1.0, 0.0, -0.0, 1e-30])
    d[1, 30:40, 5:12] = 1e18
    d[1, 7, :] = d[1, :, 7] = d[1, -8, :] = d[1, :, -8] = 32.0
    d[2] = torch.where(d[2] > 0, d[2], 33.0)
    im = img.clone()
    im[0, 17:33, 17:43] = 0.05
    got = kernel_r(d, im, plan)
    want = er.esl_refine_plain(d, im, plan)
    assert_bits_equal(got, want)
    block = want[0, 20:30, 20:40]
    assert (block == 0).any() and (block > 0).any()  # the blown-up sample won some pixels
    assert (want[2, 7:-7, 7:-7] > 0).all()


@pytest.mark.parametrize("window_size", [1, 2, 2 * er.MAX_W + 1])
def test_kernel_source_equals_plain_at_every_window(cfg, engine, kernel_r, window_size):
    depth, img = group_inputs(cfg, engine, 2, SEEDS[1])
    plan = plan_of(engine, window_size)
    assert_bits_equal(kernel_r(depth, img, plan, 16), er.esl_refine_plain(depth, img, plan, 16))


def test_kernel_source_refuses_a_wider_window(kernel_r):
    """A half-width the tile cannot hold is refused by the C entry too
    (cudaErrorInvalidValue), before any launch."""
    d = torch.ones((1, 40, 40))
    out = torch.full_like(d, -7.0)
    err = kernel_r.entry(d.data_ptr(), d.data_ptr(), d.data_ptr(), d.data_ptr(), d.data_ptr(),
                         1, 40, 40, er.MAX_W + 1, 2 * er.MAX_W + 3, 80, 45, 4, out.data_ptr(),
                         None)
    assert err == 1 and (out == -7.0).all()
