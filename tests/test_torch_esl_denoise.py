"""ESL's denoise, kernel D's wrapper and its plain versions, on the CPU.

- ``ops.esl_denoise.esl_denoise`` refuses what kernel D does not take (on
  either device, so the CPU run refuses the same inputs as the card), and
  sends CPU tensors to the plain versions, bit-equal to calling them;
- the scalars kernel D is handed equal the plain versions' float32 ones;
- kernel D's own source (``csrc/esl_denoise.cu``), compiled with g++ against
  a CPU stand-in for the CUDA runtime (``tests/cuda_cpu``) and driven by the
  wrapper's own launch sequence, equals the plain versions bit for bit: the
  TV iterations on the plain bilateral's output, and the whole denoise with
  ``torch.exp`` replaced by the C library's ``expf`` (the stand-in's; on the
  card the kernel's ``expf`` is held against ``torch.exp`` itself), on
  stacks across tiles, odd sizes smaller than a tile, an (H, W) input, a
  constant image, other parameters.

The card's comparisons are in ``tests/test_torch_cuda.py`` (``-k esl_denoise``).
"""

import ctypes
import ctypes.util
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xmaps_tpu_torch.ops import _build  # noqa: E402
from xmaps_tpu_torch.ops import esl_denoise as ed  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "xmaps_tpu_torch" / "csrc" / "esl_denoise.cu"
ENTRIES = ("esl_bilateral", "esl_tv_iteration", "esl_denoise_exp", "esl_denoise_quotient")
#: a test function compiled into the g++ build: how many float32 bit patterns
#: a, from lo by step below hi, the sweeps' division by d rounds otherwise
#: than the IEEE division does (a NaN matching any NaN)
MISMATCHES = """
#include <cstring>
extern "C" long quotient_mismatches(float d, unsigned long lo, unsigned long hi,
                                    unsigned long step) {
  const float y = __fdiv_rn(1.0f, d);
  long bad = 0;
  for (unsigned long i = lo; i < hi; i += step) {
    const unsigned bits = static_cast<unsigned>(i);
    float a;
    std::memcpy(&a, &bits, 4);
    const float got = quotient(a, d, y);
    const float want = __fdiv_rn(a, d);
    if (std::isnan(want) ? !std::isnan(got) : std::memcmp(&got, &want, 4) != 0) ++bad;
  }
  return bad;
}
"""
#: the eval's parameters (models/esl_pipeline.py BILATERAL, TV_DENOISE)
ESL = dict(d=5, sigma_color=3.0, sigma_space=3.0, mu=0.5, eps=0.1, niter=20, niter_inner=10)


def depth_like(shape, seed, holes=0.3):
    """Depths in [0.3, 1.3] m with zeros where undefined, and a step."""
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) + 0.3).astype(np.float32)
    img[rng.random(shape) < holes] = 0
    img[..., : shape[-2] // 2, :] += 0.5
    return torch.from_numpy(img)


def assert_bits_equal(got, want, msg=""):
    g, w = got.contiguous().numpy(), want.contiguous().numpy()
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=msg)


# -- the wrapper ------------------------------------------------------------------

def _refusals():
    x = torch.ones((2, 20, 30))
    return {
        "dtype": (x.double(), {}, "float32"),
        "not_contiguous": (x.transpose(1, 2), {}, "not contiguous"),
        "rank": (x[None], {}, r"\(H, W\) or \(F, H, W\)"),
        "window": (x, dict(d=2 * ed.MAX_RADIUS + 2), "half-width"),
        "negative_window": (x, dict(d=-1), "half-width"),
        "inner": (x, dict(niter_inner=ed.MAX_INNER + 1), "niter_inner"),
        "negative_inner": (x, dict(niter_inner=-1), "niter_inner"),
        "niter": (x, dict(niter=-1), "niter"),
        "divisor": (x, dict(mu=0.0, eps=0.0), "division"),
        "large_divisor": (x, dict(mu=2e6), "division"),
        "device": (x.to("meta"), {}, "unsupported device"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrapper_refuses(case):
    x, kw, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        ed.esl_denoise(x, **kw)


@pytest.mark.parametrize("shape,params", [
    ((3, 24, 40), ESL),
    ((24, 40), ESL),
    ((2, 9, 13), dict(d=3, sigma_color=0.5, sigma_space=2.0, mu=0.3, eps=0.05, niter=4,
                      niter_inner=3)),
], ids=["group", "one_scan", "other_parameters"])
def test_cpu_tensors_take_the_plain_versions(shape, params):
    x = depth_like(shape, 5)
    _build.reset_launch_counts()
    got = ed.esl_denoise(x, **params)
    assert _build.LAUNCHES["esl_denoise"] == 0  # the CPU launches nothing
    p = dict(params)
    want = ed.tv_denoise_split_bregman(
        ed.bilateral_filter(x, p.pop("d"), p.pop("sigma_color"), p.pop("sigma_space")), **p)
    assert_bits_equal(got, want)
    assert (got != x).any()


@pytest.mark.parametrize("sc,ss,mu,eps", [(3.0, 3.0, 0.5, 0.1), (0.7, 1.9, 0.3, 0.013)])
def test_scalars_are_the_plain_versions(sc, ss, mu, eps):
    """The plain versions' scalars, worked out as they work them out (0-d
    float32 tensors), are the Python floats handed to the kernel."""
    def f32(v):
        return torch.full((), v, dtype=torch.float32)

    lam = 2.0 * f32(eps)
    want = dict(inv2sc=f32(1.0) / (2.0 * f32(sc) * f32(sc)),
                inv2ss=f32(1.0) / (2.0 * f32(ss) * f32(ss)), lam=lam, thresh=f32(eps) / lam,
                diag=f32(mu) + 4.0 * lam, mu=f32(mu))
    got = ed.denoise_scalars(sc, ss, mu, eps)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.float32(got[k]).view(np.int32) == v.numpy().view(np.int32), k
        assert got[k] == float(np.float32(got[k])), k  # a float32 value, passed exactly


def test_tile_limits_are_the_kernels():
    src = SOURCE.read_text()
    assert re.search(r"constexpr int MAX_RADIUS = (\d+);", src)[1] == str(ed.MAX_RADIUS)
    assert re.search(r"constexpr int MAX_INNER = (\d+);", src)[1] == str(ed.MAX_INNER)
    assert float.fromhex(re.search(r"MIN_DIAG = (0x1p-?\d+)f;", src)[1]) == ed.MIN_DIAG
    assert float.fromhex(re.search(r"MAX_DIAG = (0x1p-?\d+)f;", src)[1]) == ed.MAX_DIAG


# -- kernel D's source on the CPU ----------------------------------------------------

@pytest.fixture(scope="module")
def kernel_d(tmp_path_factory):
    """Kernel D's C entries built with g++ against tests/cuda_cpu, the
    launches and the dynamic shared memory rewritten to the stand-in's."""
    src = SOURCE.read_text()
    launch = re.compile(r"(\w+)<<<(\w+), (dim3\([^)]*\)), (\w+), stream>>>\(")
    assert len(launch.findall(src)) == 4
    assert src.count("extern __shared__ float smem[];") == 1

    def cpu_launch(m):
        kernel, grid, block, smem = m.groups()
        if smem == "0":
            return f"cpu_launch({grid}, {block}, {kernel}, "
        return f"cpu_launch_smem({grid}, {block}, {smem}, {kernel}, "

    src = launch.sub(cpu_launch, src).replace(
        "extern __shared__ float smem[];", "float* smem = cpu_dynamic_shared<float>();")
    out = tmp_path_factory.mktemp("kernel_d")
    cpp = out / "esl_denoise.cpp"
    cpp.write_text(src + MISMATCHES)
    lib = out / "libesl_denoise.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{REPO / 'tests' / 'cuda_cpu'}", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    entries = {}
    for name in ENTRIES:
        fn = getattr(dll, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
        entries[name] = fn
    entries["quotient_mismatches"] = dll.quotient_mismatches
    entries["quotient_mismatches"].argtypes = [ctypes.c_float] + [ctypes.c_ulong] * 3
    entries["quotient_mismatches"].restype = ctypes.c_long
    return entries


@pytest.fixture
def on_cpu(kernel_d, monkeypatch):
    """``_build.launch`` sent to the g++ build, each launch counted."""
    def launch(dev, kernel, entry, *args):
        assert dev.type == "cpu" and kernel == "esl_denoise"
        assert kernel_d[entry](*args, None) == 0
        _build.LAUNCHES[kernel] += 1

    monkeypatch.setattr(_build, "launch", launch)
    _build.reset_launch_counts()
    return kernel_d


@pytest.fixture
def libc_exp(monkeypatch):
    """``torch.exp`` replaced by the C library's ``expf``, element by
    element: the stand-in's ``expf`` (the card's is held against
    ``torch.exp`` on the card)."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.expf.argtypes = [ctypes.c_float]
    libm.expf.restype = ctypes.c_float
    expf = np.vectorize(libm.expf, otypes=[np.float32])

    def exp(t):
        return torch.from_numpy(expf(t.numpy()).astype(np.float32).reshape(t.shape))

    monkeypatch.setattr(torch, "exp", exp)
    return expf


def run_kernel_d(x, d=5, sigma_color=3.0, sigma_space=3.0, mu=0.5, eps=0.1, niter=20,
                 niter_inner=10):
    return ed._kernel_d(x, d // 2, ed.denoise_scalars(sigma_color, sigma_space, mu, eps),
                        niter, niter_inner)


def plain(x, d=5, sigma_color=3.0, sigma_space=3.0, **tv):
    return ed.tv_denoise_split_bregman(ed.bilateral_filter(x, d, sigma_color, sigma_space), **tv)


def test_exp_entry_is_the_stand_ins_expf(on_cpu, libc_exp):
    x = np.concatenate([-np.geomspace(1e-30, 120, 3000), [0.0, -0.0, -np.inf, 88.0, 89.0]])
    x = torch.from_numpy(x.astype(np.float32))
    out = torch.full_like(x, 7.0)
    assert on_cpu["esl_denoise_exp"](x.data_ptr(), x.numel(), out.data_ptr(), None) == 0
    assert_bits_equal(out, torch.from_numpy(libc_exp(x.numpy())))


@pytest.mark.parametrize("shape", [(2, 50, 120), (1, 33, 21), (1, 1, 5), (1, 7, 1), (37, 66)],
                         ids=["tiles", "odd", "row", "column", "one_scan"])
def test_tv_iterations_equal_plain(on_cpu, shape):
    """The TV launches on the plain bilateral's output (no exp in them):
    across 2 x 2 tiles, inside one tile, a row, a column, an (H, W) input."""
    y = ed.bilateral_filter(depth_like(shape, 11), 5, 3.0, 3.0)
    got = ed._kernel_d(y, 0, ed.denoise_scalars(1.0, 1.0, 0.5, 0.1), 20, 10)
    assert _build.LAUNCHES["esl_denoise"] == 21
    # a bilateral of half-width 0 is the identity: the TV's input is y
    assert_bits_equal(got, ed.tv_denoise_split_bregman(y, mu=0.5))


@pytest.mark.parametrize("params", [
    dict(niter=3, niter_inner=ed.MAX_INNER, mu=0.8, eps=0.3),
    dict(niter=2, niter_inner=1),
    dict(niter=3, niter_inner=0),
    dict(niter=1, niter_inner=10),
    dict(niter=0, niter_inner=10),
], ids=["widest_halo", "one_sweep", "no_sweep", "one_iteration", "no_iteration"])
def test_tv_iterations_equal_plain_at_other_counts(on_cpu, params):
    y = ed.bilateral_filter(depth_like((2, 45, 100), 12), 5, 3.0, 3.0)
    s = ed.denoise_scalars(1.0, 1.0, params.get("mu", 0.5), params.get("eps", 0.1))
    got = ed._kernel_d(y, 0, s, params["niter"], params["niter_inner"])
    assert _build.LAUNCHES["esl_denoise"] == 1 + params["niter"]
    assert_bits_equal(got, ed.tv_denoise_split_bregman(y, **params))


@pytest.mark.parametrize("case", ["depth", "constant", "odd_sizes"])
def test_kernel_source_equals_plain(on_cpu, libc_exp, case):
    """The whole denoise, the bilateral's exp the C library's on both sides."""
    if case == "depth":
        x = depth_like((2, 50, 120), 21)
    elif case == "constant":
        x = torch.full((1, 35, 67), 0.731)
    else:
        x = depth_like((1, 3, 2), 22)
    got = run_kernel_d(x)
    assert_bits_equal(got, plain(x, mu=0.5))
    if case != "constant":
        assert (got != x).any()


@pytest.mark.parametrize("d,sigma_color,sigma_space", [(2 * ed.MAX_RADIUS + 1, 0.1, 5.0),
                                                       (1, 3.0, 3.0), (4, 0.02, 0.5)])
def test_bilateral_at_every_window(on_cpu, libc_exp, d, sigma_color, sigma_space):
    x = depth_like((2, 13, 40), 31)
    got = run_kernel_d(x, d, sigma_color, sigma_space, niter=0)
    assert_bits_equal(got, ed.bilateral_filter(x, d, sigma_color, sigma_space))


@pytest.mark.parametrize("d", [ed.denoise_scalars(3, 3, 0.5, 0.1)["diag"], 1.0, 3.3, 2.0 ** 20])
def test_sweep_division_is_ieee(kernel_d, d):
    """The sweeps' division by diag (a reciprocal and two corrections, the
    subnormal quotients rounded by their residual) against the IEEE
    division: every 5th zero or subnormal numerator, every 2039th bit
    pattern of the rest, and the entry on the array its probe takes (on the
    card: every bit pattern)."""
    count = kernel_d["quotient_mismatches"]
    for sign in (0, 1 << 31):
        assert count(d, sign, sign + (1 << 23), 5) == 0
        assert count(d, sign + (1 << 23), sign + (1 << 31), 2039) == 0
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = torch.from_numpy(np.concatenate([x, np.float32([0.0, -0.0, 1e-45, -3e-39, 1e30])]))
    out = torch.full_like(x, 7.0)
    assert kernel_d["esl_denoise_quotient"](x.data_ptr(), x.numel(), d, out.data_ptr(), None) == 0
    with np.errstate(all="ignore"):
        want = torch.from_numpy(x.numpy() / np.float32(d))
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(out), nan)
    assert_bits_equal(torch.where(nan, 0.0, out), torch.where(nan, 0.0, want))


def test_entries_refuse_what_the_tiles_cannot_hold(kernel_d):
    """A window or a sweep count the tiles cannot hold is refused by the C
    entries too (cudaErrorInvalidValue), before any launch."""
    x = torch.ones((1, 8, 8))
    out = torch.full_like(x, -7.0)
    p, o = x.data_ptr(), out.data_ptr()
    assert kernel_d["esl_bilateral"](p, 1, 8, 8, ed.MAX_RADIUS + 1, 1.0, 1.0, o, None) == 1
    assert kernel_d["esl_tv_iteration"](p, p, None, None, 1, 8, 8, 0.5, 0.2, 0.5, 1.3,
                                        ed.MAX_INNER + 1, 1, o, None, None, None) == 1
    assert kernel_d["esl_tv_iteration"](p, p, p, None, 1, 8, 8, 0.5, 0.2, 0.5, 1.3,
                                        10, 0, o, None, None, None) == 1
    assert kernel_d["esl_denoise_quotient"](p, 8, 2.0 ** 21, o, None) == 1
    assert kernel_d["esl_tv_iteration"](p, p, None, None, 1, 8, 8, 0.5, 0.2, 0.5, 2.0 ** -21,
                                        10, 1, o, None, None, None) == 1
    assert (out == -7.0).all()
