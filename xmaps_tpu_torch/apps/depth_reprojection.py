"""Replay depth estimation CLI.

Port of ``xmaps_tpu.apps.depth_reprojection``: the same flags as the
reference entry point (depth_reprojection.py:32-61) and the JAX app, plus
``--device {cuda,cpu}`` (default cuda; cpu runs the kernels' plain
versions).

    python -m xmaps_tpu_torch.apps.depth_reprojection \\
        --calib data/calib.yaml --input recording.raw \\
        --projector-width 720 --projector-height 1280 --device cuda

Live capture (``--capture``, or no ``--input``) is not ported yet
(ROADMAP.md) and raises NotImplementedError.
"""

from __future__ import annotations

import contextlib
import os
import sys

import click

from xmaps_tpu_torch.config import EV_PACKETS_PER_FRAME, RuntimeParams
from xmaps_tpu_torch.io.event_iterator import FileEventsIterator
from xmaps_tpu_torch.runtime.processor import DepthReprojectionProcessor


def project_events(bias, input, capture, params, delta_t, ev_processor):
    """Replay loop: pull delta_t packets through the processor
    (reference: depth_reprojection.py:10-29)."""
    mv_iterator = FileEventsIterator(
        input_filename=input, delta_t=delta_t, bias_file=bias
    )
    cam_height_reader, cam_width_reader = mv_iterator.get_size()
    if (cam_height_reader, cam_width_reader) != (
        params.camera_height, params.camera_width
    ):
        raise ValueError(
            f"stream geometry {cam_width_reader}x{cam_height_reader} != "
            f"camera {params.camera_width}x{params.camera_height}"
        )

    for evs in mv_iterator:
        with ev_processor.stats_printer.measure_time("main loop"):
            if not len(evs):
                continue
            ev_processor.process_events(evs)
            if ev_processor.should_close():
                sys.exit(0)


@contextlib.contextmanager
def torch_trace(profile_dir: str, device: str):
    """torch.profiler over the block (host, plus the card on CUDA),
    written to ``profile_dir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


@click.command()
@click.option("--projector-width", default=720, help="Scanning-projector horizontal resolution [px]", type=int)
@click.option("--projector-height", default=1280, help="Scanning-projector vertical resolution [px]", type=int)
@click.option("--projector-fps", default=60, help="Projector refresh rate [Hz]; sets the frame segmentation period", type=int)
@click.option(
    "--projector-time-map",
    help="Precalibrated rectified projector time map (.npy). Without it, the "
    "ideal linear scan pattern is synthesized and rectified at startup.",
    type=click.Path(),
)
@click.option("--z-near", default=0.1, help="Near clip [m] of the depth colormap", type=float)
@click.option("--z-far", default=1.0, help="Far clip [m] of the depth colormap", type=float)
@click.option(
    "--calib",
    help="OpenCV-style YAML with the stereo (camera+projector) calibration (X-maps dialect)",
    type=click.Path(exists=True),
    required=True,
)
@click.option("--bias", help="Sensor .bias settings file (unused for file replay)", type=click.Path())
@click.option(
    "--input",
    help="Prerecorded event stream to replay: EVT2/EVT3 .raw, .dat, or "
    "structured .npy.",
    type=click.Path(exists=True),
    default=None,
)
@click.option(
    "--capture",
    default=None,
    help="Live-capture backend (not ported yet: raises NotImplementedError).",
)
@click.option("--loop-input", help="Restart the replay from the top when the file ends", is_flag=True)
@click.option(
    "--no-frame-dropping",
    help="Disable the timing watchdog: never skip a frame of events to catch up with the stream",
    is_flag=True,
)
@click.option(
    "--camera-perspective",
    help="Render depth on the raw camera grid instead of the default "
    "projector-view reprojection (the SAR use case).",
    is_flag=True,
)
@click.option(
    "--window",
    default="none",
    type=click.Choice(["none", "files", "cv2"]),
    help="Display sink: none (headless), files (PNG dumps), cv2 (GUI window).",
)
@click.option("--out-dir", default="frames_out", help="Directory for --window files")
@click.option("--camera-width", default=640, type=int)
@click.option("--camera-height", default=480, type=int)
@click.option(
    "--low-latency",
    is_flag=True,
    help="Flush every depth frame synchronously instead of keeping one "
    "frame in flight: minimum display latency, lower throughput.",
)
@click.option(
    "--profile-dir",
    default=None,
    type=click.Path(),
    help="Write a torch.profiler trace of the replay (host, and the card on "
    "CUDA) to DIR/trace.json",
)
@click.option(
    "--device",
    default="cuda",
    type=click.Choice(["cuda", "cpu"]),
    help="Where the engine runs: cuda (the kernels) or cpu (their plain versions)",
)
def main(
    bias, input, capture, loop_input, window, out_dir, profile_dir,
    low_latency, device, **cli_params,
):
    params = RuntimeParams(**cli_params)

    delta_t = 1e6 / params.projector_fps / EV_PACKETS_PER_FRAME
    print(
        f"Using delta_t={delta_t:.2f} us to process "
        f"{EV_PACKETS_PER_FRAME} ev packets per projector frame."
    )
    if not input:
        raise NotImplementedError(
            "live capture (--capture, or no --input) is not ported to "
            "xmaps_tpu_torch yet (ROADMAP.md); replay a file with --input"
        )

    trace_cm = (
        torch_trace(profile_dir, device)
        if profile_dir is not None
        else contextlib.nullcontext()
    )
    with DepthReprojectionProcessor(
        params=params, device=device, window_kind=window, out_dir=out_dir,
        low_latency=low_latency,
    ) as ev_processor, trace_cm:
        while True:
            project_events(bias, input, capture, params, delta_t, ev_processor)
            if loop_input:
                ev_processor.reset()
            else:
                break


if __name__ == "__main__":
    main()
