"""Shared pieces of the measurement tools (``apps.profile_setup``,
``check_bitexact``, ``profile_trace``, ``profile_stages``,
``bench_esl_init``, ``profile_esl_init``).

- ``tool_rig``: the rig of a tool's ``--geometry`` (``apps.bench_geometry.rig``:
  the demonstrator, or the synthetic ESL rig with its rectified frame at 3x
  the projector), or one of other sizes through ``--camera`` and
  ``--projector`` (``add_rig_args``; small rigs run the tools on the CPU in
  seconds);
- ``card``: the card's name and power limit for a tool's JSON line (null on
  the CPU);
- ``call_spans``: the span of each call's device events in a profiled window
  (``utils.profiling.device_events``).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from xmaps_tpu_torch.apps.bench import card_name_and_power_limit
from xmaps_tpu_torch.apps.bench_geometry import rig
from xmaps_tpu_torch.calib.maps import CalibrationParams
from xmaps_tpu_torch.utils.synthetic import make_synthetic_calibration

__all__ = ["add_rig_args", "tool_rig", "card", "call_spans", "sync"]

#: the ESL rig's rectified frame, in projector sizes (``from_esl_yaml``'s
#: ``rectification_scale``)
ESL_RECT_SCALE = 3


def add_rig_args(ap: argparse.ArgumentParser) -> None:
    """``--camera W H`` and ``--projector W H``: the rig's sizes in place of
    the geometry's (default: the geometry's own)."""
    ap.add_argument("--camera", type=int, nargs=2, metavar=("W", "H"), default=None,
                    help="camera size in place of the geometry's (a small rig for a CPU run)")
    ap.add_argument("--projector", type=int, nargs=2, metavar=("W", "H"), default=None,
                    help="projector size in place of the geometry's")


def tool_rig(geometry: str, camera=None, projector=None) -> CalibrationParams:
    """``apps.bench_geometry.rig(geometry)``, or with ``camera`` / ``projector``
    (``(W, H)``) the synthetic rig of those sizes; an ESL rig keeps its
    rectified frame at 3x the projector."""
    base = rig(geometry)
    if camera is None and projector is None:
        return base
    cw, ch = camera or (base.camera_width, base.camera_height)
    pw, ph = projector or (base.projector_width, base.projector_height)
    calib = make_synthetic_calibration(camera_width=cw, camera_height=ch,
                                       projector_width=pw, projector_height=ph)
    if geometry == "esl":
        calib = dataclasses.replace(calib, rect_image_width=ESL_RECT_SCALE * pw,
                                    rect_image_height=ESL_RECT_SCALE * ph)
    return calib


def card(dev: torch.device) -> dict:
    """``{"gpu": name, "power_limit_w": W}`` as nvidia-smi reports them, both
    None on the CPU."""
    gpu, power = card_name_and_power_limit() if dev.type == "cuda" else (None, None)
    return {"gpu": gpu, "power_limit_w": power}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def call_spans(events: list, calls: int) -> list:
    """The span in us, first start to last end, of each of ``calls`` calls
    whose device events ``events`` (``(name, start us, duration us)`` in time
    order, the same number a call) holds back to back on one stream."""
    if not events or len(events) % calls:
        raise ValueError(f"{len(events)} device events do not split into {calls} calls")
    k = len(events) // calls
    chunks = [events[i * k:(i + 1) * k] for i in range(calls)]
    return [max(s + d for _, s, d in c) - c[0][1] for c in chunks]
