"""The port's copies of the host calibration code equal the JAX package's.

xmaps_tpu_torch carries copies of xmaps_tpu.calib, .config constants,
.utils.colormap and .utils.synthetic so that it imports nothing of the JAX
package; these tests pin every array the engine consumes equal on two rigs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import xmaps_tpu.config as jcfg  # noqa: E402
from xmaps_tpu.calib.maps import CamProjMaps as JMaps  # noqa: E402
from xmaps_tpu.utils.colormap import TURBO_BGR_U8 as J_TURBO  # noqa: E402
from xmaps_tpu.utils.synthetic import (  # noqa: E402
    make_synthetic_calibration as j_calib,
    simulate_plane_events as j_sim,
    simulate_sequence as j_seq,
)

import xmaps_tpu_torch.config as tcfg  # noqa: E402
from xmaps_tpu_torch.calib.maps import CamProjMaps as TMaps  # noqa: E402
from xmaps_tpu_torch.utils.colormap import TURBO_BGR_U8 as T_TURBO  # noqa: E402
from xmaps_tpu_torch.utils.synthetic import (  # noqa: E402
    make_synthetic_calibration as t_calib,
    simulate_plane_events as t_sim,
    simulate_sequence as t_seq,
)

torch.set_num_threads(1)

RIGS = [
    dict(camera_width=128, camera_height=96, projector_width=180, projector_height=320),
    dict(),  # make_synthetic_calibration defaults
]


def test_constants_and_colormap():
    for name in ("X_OFFSET", "RECTIFICATION_SCALE_XMAPS",
                 "RECTIFICATION_SCALE_ESL", "DILATE_KERNEL",
                 "EV_PACKETS_PER_FRAME", "MIN_EVENTS_PER_FRAME",
                 "FRAME_PAUSED_THRESH_US"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    t = tcfg.PipelineConfig(1, 2, 90, 4, 5, 6)
    j = jcfg.PipelineConfig(1, 2, 90, 4, 5, 6)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.x_map_width, t.t_px_scale) == (j.x_map_width, j.t_px_scale)
    np.testing.assert_array_equal(T_TURBO, J_TURBO)
    assert T_TURBO.dtype == J_TURBO.dtype


@pytest.mark.parametrize("rig", RIGS, ids=["graft_rig", "default_rig"])
def test_cam_proj_maps_equal(rig):
    jc, tc = j_calib(**rig), t_calib(**rig)
    for f in dataclasses.fields(jc):
        np.testing.assert_array_equal(getattr(tc, f.name), getattr(jc, f.name))
    jm, tm = JMaps(jc), TMaps(tc)
    for name in JMaps._ARRAY_FIELDS:
        a, b = getattr(jm, name), getattr(tm, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for border in (False, True):
        np.testing.assert_array_equal(
            tm.build_rectified_time_map(border_replicate=border),
            jm.build_rectified_time_map(border_replicate=border),
        )
    ej = j_sim(jc, depth_m=0.6, subsample=0.5, jitter_us=2.0,
               rng=np.random.default_rng(5))
    et = t_sim(tc, depth_m=0.6, subsample=0.5, jitter_us=2.0,
               rng=np.random.default_rng(5))
    np.testing.assert_array_equal(et, ej)


def test_runtime_params_equal():
    assert ([(f.name, f.default) for f in dataclasses.fields(tcfg.RuntimeParams)]
            == [(f.name, f.default) for f in dataclasses.fields(jcfg.RuntimeParams)])
    args = (640, 480, 720, 1280, 60, 0.2, 1.2, "c.yaml")
    for kw in ({}, dict(no_frame_dropping=True, camera_perspective=True)):
        t, j = tcfg.RuntimeParams(*args, **kw), jcfg.RuntimeParams(*args, **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.should_drop_frames == j.should_drop_frames


def test_simulate_sequence_equal():
    """The multi-frame stream with blanking gaps (what the trigger finder
    segments) equals the JAX package's, seed for seed."""
    calib = t_calib(camera_width=128, camera_height=96, projector_width=180,
                    projector_height=320)
    jcalib = j_calib(camera_width=128, camera_height=96, projector_width=180,
                     projector_height=320)
    kw = dict(fps=60, subsample=0.3)
    et = t_seq(calib, [0.5, 0.6, 0.7], rng=np.random.default_rng(3), **kw)
    ej = j_seq(jcalib, [0.5, 0.6, 0.7], rng=np.random.default_rng(3), **kw)
    assert len(et) > 3000
    np.testing.assert_array_equal(et, ej)


def test_cv_yaml_parse_matches(tmp_path):
    """The copy with the lazy yaml import parses both matrix dialects like
    the JAX package."""
    from xmaps_tpu.calib.cv_yaml import load_cv_yaml as j_load
    from xmaps_tpu_torch.calib.cv_yaml import load_cv_yaml as t_load

    p = tmp_path / "c.yaml"
    p.write_text(
        "%YAML:1.0\n---\nR: !!opencv-matrix\n   rows: 1\n   cols: 2\n"
        "   dt: d\n   data: [ 1., 2. ]\n"
        "camera_intrinsic_matrix:\n  type-id: opencv_matrix\n  rows: 1\n"
        "  cols: 1\n  data: [3.0]\n"
    )
    assert t_load(str(p)) == j_load(str(p))


def _ast_without_imports(path):
    """The module's AST with every import statement (at any depth) and the
    JAX platform pin of the JAX package's CLIs taken out."""
    import ast

    tree = ast.parse(path.read_text())

    class Strip(ast.NodeTransformer):
        def visit_Import(self, node):
            return None

        def visit_ImportFrom(self, node):
            return None

        def visit_Expr(self, node):
            call = node.value
            if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
                    and call.func.id == "respect_jax_platforms"):
                return None
            return node

    return ast.dump(Strip().visit(tree))


@pytest.mark.parametrize("module", ["utils/ply.py", "utils/stats.py",
                                    "utils/eval_metrics.py", "apps/eval_table.py"])
def test_eval_copies_equal_apart_from_imports(module):
    """The eval helpers the port carries as copies equal the originals
    statement for statement; only their imports point elsewhere."""
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    port = repo / "xmaps_tpu_torch" / module
    assert _ast_without_imports(port) == _ast_without_imports(repo / "xmaps_tpu" / module)
    assert "xmaps_tpu." not in port.read_text().replace("xmaps_tpu_torch.", "")


@pytest.mark.parametrize("module", ["runtime/trigger_finder.py", "runtime/watchdog.py"])
def test_runtime_copies_equal_apart_from_imports(module):
    """The streaming runtime's trigger finder (frame segmentation, with the
    global-index bookkeeping) and watchdog are copies of the originals."""
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    port = repo / "xmaps_tpu_torch" / module
    assert _ast_without_imports(port) == _ast_without_imports(repo / "xmaps_tpu" / module)
    assert "xmaps_tpu." not in port.read_text().replace("xmaps_tpu_torch.", "")
