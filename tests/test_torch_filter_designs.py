"""``experiments/filter_designs.py`` on the CPU.

The designs themselves run only on a card (``python3
experiments/filter_designs.py``); here: the script refuses to run without
one and imports no JAX, its C signatures name every entry of the ``.cu``,
its copy of the port's ``csrc/filters.cu`` and its copies of the cluster
design (early stops, other block sizes) find every point they cut or
patch, the cluster design's launch plan against the card's limits at the
repo's key spaces, and its ptxas parser.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "experiments"))
sys.path.insert(0, str(ROOT))

import filter_designs as fd  # noqa: E402

from xmaps_tpu_torch.ops.filters import FILTER_NAMES, MAX_GROUP_FRAMES  # noqa: E402

PORT_KERNEL = ROOT / "xmaps_tpu_torch" / "csrc" / "filters.cu"


def test_designs_script_needs_a_card_and_imports_no_jax():
    code = ("import sys; sys.path.insert(0, 'experiments'); import torch; "
            "torch.cuda.is_available = lambda: False; import filter_designs as f; "
            "rc = f.main([]); assert 'jax' not in sys.modules, 'jax imported'; sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert "needs a CUDA GPU" in proc.stderr


def test_signatures_name_the_c_entries():
    entries = set(re.findall(r'extern "C" int (\w+)\(', fd.SOURCE.read_text()))
    assert entries == set(fd._SIGNATURES)
    assert 'extern "C"' not in fd.CLUSTER_SOURCE.read_text()


def test_the_includes_are_the_files_the_build_writes():
    """filter_designs.cu includes exactly the two files ``build`` writes,
    and neither name is taken beside it (a quoted include would find that
    file before the build's)."""
    includes = re.findall(r'^#include "([^"]+)"', fd.SOURCE.read_text(), re.M)
    assert sorted(includes) == sorted([fd.PORT_INCLUDE, fd.CLUSTER_INCLUDE])
    for name in includes:
        assert not (fd.SOURCE.parent / name).exists()


def test_the_port_copy_is_the_port_kernel_in_its_namespace():
    """``port_copy`` keeps the port's kernel whole, in namespace ``port``
    after the includes, and cuts off its C entries (the library's entries
    are filter_designs.cu's)."""
    src = PORT_KERNEL.read_text()
    out = fd.port_copy(src)
    head, body = src.split("\nnamespace {\n", 1)
    kernel = body[:body.index('\nextern "C"')]
    assert out.startswith(head + "\nnamespace port {\nnamespace {\n" + kernel)
    assert out.endswith("}  // namespace port\n")
    assert 'extern "C"' not in out and "#include" not in out[len(head):]
    for there in ("frame_dedup_filter_kernel(Params P)", "int launch(", "grid.sync()",
                  "cudaLaunchCooperativeKernel"):
        assert there in out


def test_the_cluster_copies_find_their_patch_points():
    """Each stop of ``STOPS`` is inserted once, after its statement; each
    build of ``VARIANTS`` sets its block size and cluster; the first is
    the source as it is, whose constants ``cluster_plan`` mirrors; the
    design is a cluster launch with no grid barrier, cooperative only as an
    attribute beside the cluster dimension."""
    src = fd.CLUSTER_SOURCE.read_text()
    stopped = fd.stoppable(src)
    for k, at in fd.STOPS.items():
        head = at.split("\n", 1)[0]
        assert f"{head}\n  if (kernel_f_stop == {k}) return;\n" in stopped
    assert stopped.count("kernel_f_stop ==") == len(fd.STOPS) == len(fd.SPLIT_NAMES)
    for threads, cluster in fd.VARIANTS:
        out = fd.variant(src, threads, cluster)
        assert f"constexpr int THREADS = {threads};" in out
        assert f"constexpr int CLUSTER = {cluster};" in out
        assert f"int warp_sums[{threads // 32}];" in out
        assert fd.CLUSTER_LANES % (threads * cluster) == 0
    assert fd.variant(src, *fd.PLAN_VARIANT) == src
    consts = dict(re.findall(r"constexpr (?:int|long) (\w+) = (\d+);", src))
    assert (int(consts["THREADS"]), int(consts["CLUSTER"])) == fd.PLAN_VARIANT == (
        fd.CLUSTER_THREADS, fd.CLUSTER_BLOCKS)
    assert int(consts["LANES"]) == fd.CLUSTER_LANES
    assert int(consts["MAX_SMEM"]) == fd.CLUSTER_MAX_SMEM
    assert int(consts["MAX_FRAMES"]) == fd.MAX_FRAMES == MAX_GROUP_FRAMES
    assert FILTER_NAMES.index("first_per_yt") == int(consts["FIRST_PER_YT"])
    assert FILTER_NAMES.index("mean_first_last_per_xy") == int(consts["MEAN_FIRST_LAST_PER_XY"])
    small = re.search(r"struct Small \{(.*?)\};", src, re.S).group(1)
    ints = re.findall(r"^\s*int \w+\[(\d+)\];", small, re.M)
    longs = re.findall(r"^\s*long long \w+\[(\d+)\];", small, re.M)
    assert 4 * sum(map(int, ints)) + 8 * sum(map(int, longs)) == fd.CLUSTER_SMALL_BYTES
    code = re.sub(r"//[^\n]*", "", src)
    for gone in ("cudaLaunchCooperativeKernel", "this_grid", "grid.sync", "grid_group"):
        assert gone not in code
    for there in ("cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension",
                  "cudaLaunchAttributeCooperative", "cudaOccupancyMaxActiveClusters",
                  "map_shared_rank"):
        assert there in code


#: the card's limits: shared memory a block (227 KB), blocks a cluster
SMEM_LIMIT, CLUSTER_LIMIT = 232448, 16
#: a block's shared memory at each of the repo's key spaces (the xy
#: filters at both rigs, first_per_yt at the demonstrator and at the ESL
#: rig), as the cluster design's header reckons it: its share of a part's
#: bitmap words at 8 B a word after the 336 B head; a group of 12 has one
#: part a frame (9.6, 26.4, 86.4 KB), one frame 8 parts
BLOCK_BYTES = {(12, 640 * 480): 336 + 9608, (12, 480 * 1760): 336 + 26408,
               (12, 480 * 5760): 336 + 86408, (1, 640 * 480): 336 + 1208,
               (1, 480 * 1760): 336 + 3304, (1, 480 * 5760): 336 + 10808}


@pytest.mark.parametrize("frames, n_keys", sorted(BLOCK_BYTES))
def test_cluster_plan_at_the_repo_key_spaces(frames, n_keys):
    """Every key space of the repo's rigs keeps its bitmap in shared
    memory, within the card's limits: 8 parts for one frame, 1 for a group
    of 12, blocks = frames x parts x 16, no steps at the capacity."""
    plan = fd.cluster_plan(frames, 28672, n_keys, "first_per_yt")
    assert plan.bitmap == "shared"
    assert plan.smem_bytes == BLOCK_BYTES[(frames, n_keys)] <= SMEM_LIMIT
    assert plan.parts == {1: 8, 12: 1}[frames]
    assert plan.blocks == frames * plan.parts * CLUSTER_LIMIT
    assert plan.steps == 0


@pytest.mark.parametrize("frames", [1, 12])
def test_cluster_plan_moves_the_bitmap_to_global_past_the_limit(frames):
    """A part of 7,427,584 slots is the most whose bitmap (2 x 232,112
    words over 16 blocks at 8 B, after the head) fits a block's 227 KB;
    one slot more a part puts the bitmaps in global scratch."""
    parts = fd.cluster_plan(frames, 64, 1000, "first_per_xy").parts
    last = parts * 7427584 - 1  # n_keys: size = n_keys + 1 slots
    at = fd.cluster_plan(frames, 64, last, "first_per_xy")
    past = fd.cluster_plan(frames, 64, last + 1, "first_per_xy")
    assert (at.bitmap, past.bitmap) == ("shared", "global")
    assert at.smem_bytes == SMEM_LIMIT and past.smem_bytes == 336


def test_cluster_plan_walks_past_the_held_lanes():
    """A frame of more lanes than a cluster holds walks the rest in steps
    of 16 x 512 lanes."""
    for n, steps in ((1, 0), (32768, 0), (32769, 1), (32768 + 8192, 1), (32768 + 8193, 2),
                     (524286, 60)):
        assert fd.cluster_plan(3, n, 307200, "last_per_xy").steps == steps


@pytest.mark.parametrize("case", ["none", "frames", "no_frames", "lanes", "keys", "no_keys"])
def test_cluster_plan_refuses(case):
    args = dict(frames=2, n=64, n_keys=1000, name="first_per_xy")
    args.update({"none": dict(name="none"), "frames": dict(frames=MAX_GROUP_FRAMES + 1),
                 "no_frames": dict(frames=0), "lanes": dict(n=0),
                 "keys": dict(n_keys=(1 << 29) + 1), "no_keys": dict(n_keys=0)}[case])
    with pytest.raises(ValueError, match="cluster design"):
        fd.cluster_plan(**args)


def test_registers_parses_ptxas():
    log = ("ptxas info    : Compiling entry function '_ZN5kernelEv' for 'sm_90a'\n"
           "    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 56 registers, 384 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_ZN5otherEv' for 'sm_90a'\n"
           "ptxas info    : Used 4 registers, 360 bytes cmem[0]\n")
    assert fd.registers(log) == {"_ZN5kernelEv": (56, 8), "_ZN5otherEv": (4, 0)}
