"""``experiments/kernel1_designs.py`` and kernel 1's byte bounds on the CPU.

The designs themselves run only on a card (``python3
experiments/kernel1_designs.py``); here: the script refuses to run without
one and imports no JAX, its names cover every design of the ``.cu``, its
ptxas parser, and its bound against ``chip_smoke.kernel_bytes``.
"""

import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "experiments"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import kernel1_designs as k1  # noqa: E402


def test_designs_script_needs_a_card_and_imports_no_jax():
    code = ("import sys; sys.path.insert(0, 'experiments'); import torch; "
            "torch.cuda.is_available = lambda: False; import kernel1_designs as k; "
            "rc = k.main([]); assert 'jax' not in sys.modules, 'jax imported'; sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert "needs a CUDA GPU" in proc.stderr


def test_design_names_cover_the_c_entries():
    """Every ablation mode and candidate variant the ``.cu`` dispatches has
    a name in the script, and no name lacks a case."""
    src = k1.SOURCE.read_text()

    def cases(entry):
        body = src[src.index(f'extern "C" int {entry}('):]
        body = body[:body.index("return cudaErrorInvalidValue;\n  });")]
        return {int(n) for n in re.findall(r"case (\d+):", body)}

    assert cases("design_ablation") == set(k1.ABLATIONS)
    assert cases("design_candidate") == set(k1.CANDIDATES)
    assert len(set(k1.ABLATIONS.values()) | set(k1.CANDIDATES.values())
               | {k1.PREVIOUS, k1.SHIPPED}) == len(k1.ABLATIONS) + len(k1.CANDIDATES) + 2


def test_registers_parses_ptxas_lines():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN8previous30event_disparity_scatter_kernelE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN8previous30event_disparity_scatter_kernelE",
        "ptxas info    : Used 28 registers, used 1 barriers, 392 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN9candidate16candidate_kernelE' for 'sm_90a'",
        "ptxas info    : Used 40 registers, 4096 bytes smem",
    ])
    # the namespace is dropped from the mangled name
    assert k1.registers(log) == {"_Z30event_disparity_scatter_kernelE": 28,
                                 "_Z16candidate_kernelE": 40}
    assert k1.registers("") == {}


@pytest.mark.parametrize("counts", [(27755,), (27755, 0, 28672, 1)])
def test_bound_is_chip_smokes_kernel_bytes(counts):
    """The experiment's bound is ``chip_smoke.kernel_bytes`` of the entry it
    times: the staged one-frame entry (the host passes the count) or the
    staged group (each count read from the device and written)."""
    tables = SimpleNamespace(cam_map_packed=torch.zeros(480, 640, dtype=torch.int32),
                             x_map=torch.zeros(1760, 1280, dtype=torch.int16))
    eng = SimpleNamespace(tables=tables)
    out_px = 901 * 532
    tab = (640 * 480 * 4, 1760 * 1280 * 2)
    if len(counts) == 1:
        name, shape = "event_disparity_scatter_staged", (counts[0], *tab, out_px)
    else:
        name, shape = "event_disparity_scatter_group", (counts, *tab, out_px)
    want = cs.kernel_bytes(name, {name: shape}) / cs.HBM_BYTES_PER_S * 1e3
    assert k1.bound_ms(eng, counts, out_px) == pytest.approx(want, rel=1e-12)


def test_staged_bytes_are_the_group_bytes_of_one_frame_less_its_count_read():
    tab = (1228800, 4505600)
    one = cs.kernel_bytes("event_disparity_scatter_staged",
                          {"event_disparity_scatter_staged": (1000, *tab, 6000)})
    group = cs.kernel_bytes("event_disparity_scatter_group",
                            {"event_disparity_scatter_group": ((1000,), *tab, 6000)})
    assert one == 4 * 1000 + 4 * 1000 + 2 * 1000 + 4 * 6000 + 4 == group - 4
    # a gather reads at most the whole table
    big = cs.kernel_bytes("event_disparity_scatter_staged",
                          {"event_disparity_scatter_staged": (10**7, 100, 60, 0)})
    assert big == 4 * 10**7 + 100 + 60 + 4
