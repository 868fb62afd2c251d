"""Session lifecycle: pipeline + display window + keyboard controls.

Port of ``xmaps_tpu.runtime.processor``, the counterpart of the reference
DepthReprojectionProcessor (depth_reprojection_processor.py:50-114).  The
display seam (should_close / show_async / set_keyboard_callback, the same
3-method interface the reference proves out with FakeWindow) is satisfied
by: FakeWindow (no-op), FileSinkWindow (PNG sequence), or an OpenCV window
when a GUI stack is importable.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from xmaps_tpu_torch.config import RuntimeParams
from xmaps_tpu_torch.runtime.pipe import DepthReprojectionPipe
from xmaps_tpu_torch.utils.stats import StatsPrinter


class FakeWindow:
    """Headless stand-in (reference: depth_reprojection_processor.py:39-47)."""

    def should_close(self) -> bool:
        return False

    def show_async(self, img) -> None:
        pass

    def set_keyboard_callback(self, cb) -> None:
        pass


class FileSinkWindow:
    """Writes every Nth frame as a PNG to a directory.

    Declares demand per frame via ``wants_frame`` so the pipe never
    fetches the device image for the N-1 frames it would discard.
    """

    def __init__(self, out_dir: str, every: int = 30):
        self.out_dir = out_dir
        self.every = every
        self._i = 0
        self._pending = None  # frame index of the last accepted probe
        os.makedirs(out_dir, exist_ok=True)

    def should_close(self) -> bool:
        return False

    def wants_frame(self, i: int) -> bool:
        want = i % self.every == 0
        if want:
            self._pending = i
        return want

    def show_async(self, img: np.ndarray) -> None:
        from PIL import Image

        # Filenames carry the true frame index: the probe's index when the
        # processor drives demand through wants_frame, or a plain call
        # counter for direct callers that show every frame.
        idx = self._i if self._pending is None else self._pending
        self._pending = None
        self._i = idx + 1
        # frames are BGR (reference window mode); PNG wants RGB
        Image.fromarray(img[..., ::-1]).save(
            os.path.join(self.out_dir, f"depth_{idx:06d}.png")
        )

    def set_keyboard_callback(self, cb) -> None:
        pass


def make_window(kind: str, params: RuntimeParams, out_dir: str = "frames_out"):
    if kind == "none":
        return FakeWindow()
    if kind == "files":
        return FileSinkWindow(out_dir)
    if kind == "cv2":
        import cv2

        class Cv2Window:
            def __init__(self):
                self._close = False
                self._cb: Optional[Callable] = None
                cv2.namedWindow("X Maps Depth")

            def should_close(self):
                return self._close

            def show_async(self, img):
                cv2.imshow("X Maps Depth", img)
                key = cv2.waitKey(1) & 0xFF
                if key in (27, ord("q")):
                    self._close = True
                elif self._cb is not None and key != 0xFF:
                    self._cb(key)

            def set_keyboard_callback(self, cb):
                self._cb = cb

        return Cv2Window()
    raise ValueError(f"unknown window kind {kind!r}")


@dataclass
class DepthReprojectionProcessor:
    """Context manager owning the pipeline and the display."""

    params: RuntimeParams
    #: the engine's device, "cuda" or "cpu"
    device: str = "cuda"
    window_kind: str = "none"
    out_dir: str = "frames_out"
    low_latency: bool = False

    stats_printer: StatsPrinter = field(default_factory=StatsPrinter)
    _pipe: DepthReprojectionPipe = field(init=False, default=None)
    _window: object = field(init=False, default=None)

    def should_close(self) -> bool:
        return self._window.should_close()

    def show_async(self, depth_map: np.ndarray):
        self._window.show_async(depth_map)
        self.stats_printer.count("frames shown")

    def _frame_wanted(self) -> bool:
        """Per-frame display demand (called once per finished frame by the
        pipe): windows without a wants_frame method take every frame."""
        i = self._frame_idx
        self._frame_idx += 1
        probe = getattr(self._window, "wants_frame", None)
        return True if probe is None else bool(probe(i))

    def __enter__(self):
        self._frame_idx = 0
        self._pipe = DepthReprojectionPipe(
            params=self.params,
            stats_printer=self.stats_printer,
            frame_callback=self.show_async,
            device=self.device,
            frame_wanted=self._frame_wanted,
            low_latency=self.low_latency,
        )
        self._window = make_window(self.window_kind, self.params, self.out_dir)
        self._window.set_keyboard_callback(self.keyboard_cb)
        return self

    def __exit__(self, *exc_info):
        self._pipe.flush()
        self.stats_printer.print_stats()
        return False

    def keyboard_cb(self, key):
        """E: cycle frame event filters, S: toggle stats (reference:
        depth_reprojection_processor.py:97-105)."""
        if key in (ord("e"), ord("E")):
            self._pipe.select_next_frame_event_filter()
        elif key in (ord("s"), ord("S")):
            self.stats_printer.toggle_silence()

    def process_events(self, evs: np.ndarray):
        self.stats_printer.print_stats_if_needed()
        self.stats_printer.count("processed evs", len(evs))
        self._pipe.process_events(evs)
        self.stats_printer.print_stats_if_needed()

    def reset(self):
        self._pipe.reset()
