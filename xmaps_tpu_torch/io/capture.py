"""Pluggable live-capture backends (the camera hardware seam).

Port of ``xmaps_tpu.io.capture`` (equal apart from its imports and
docstrings).  The reference opens a Prophesee camera through the
Metavision HAL, programs its bias registers from a ``.bias`` file, and
streams decoded event chunks (bias_events_iterator.py:66-90).  A host may
have no event camera attached, so this module defines the seam as a small
registry of backends instead of a hard dependency:

- :class:`CaptureBackend` / :class:`CaptureSession` -- the interface a HAL
  adapter implements (open by serial, report geometry, program biases,
  yield delta_t-sized structured packets);
- :func:`register_capture_backend` / :func:`open_capture` -- discovery;
  the backend is picked explicitly (``name`` or ``name:serial``), via the
  ``XMAPS_CAPTURE_BACKEND`` env var, or automatically when exactly one
  real backend is registered;
- :class:`SyntheticCaptureBackend` (registered as ``synthetic``) -- a
  complete in-tree implementation that emits a wall-clock-paced stream of
  synthetic projector frames, so the live path of the app (and its tests)
  run end-to-end without hardware;
- :class:`LiveEventsIterator` -- adapts a session to the same surface as
  io.event_iterator.FileEventsIterator (``get_size()`` + packet
  iteration), which is all the runtime sees.

A Metavision-based backend (``io.capture_metavision``) registers itself
with::

    from xmaps_tpu_torch.io.capture import CaptureBackend, register_capture_backend

    class MetavisionBackend(CaptureBackend):
        name = "metavision"
        def open(self, serial="", **hints):
            ...  # DeviceDiscovery.open(serial), I_LL_Biases writes,
                 # EventsIterator -> packets (bias_events_iterator.py:66-90)

    register_capture_backend(MetavisionBackend())
"""

from __future__ import annotations

import abc
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np

from xmaps_tpu_torch.io.biases import load_bias_file
from xmaps_tpu_torch.io.evt_decoder import EVENT_DTYPE

__all__ = [
    "CaptureBackend",
    "CaptureSession",
    "LiveEventsIterator",
    "SyntheticCaptureBackend",
    "register_capture_backend",
    "capture_backends",
    "open_capture",
]


class CaptureSession(abc.ABC):
    """An open camera: geometry, bias programming and the packet stream."""

    @abc.abstractmethod
    def get_size(self) -> tuple[int, int]:
        """(height, width) of the sensor, Metavision orientation
        (reference: bias_events_iterator.py:95-96)."""

    def set_biases(self, biases: Dict[str, int]) -> None:
        """Program sensor bias registers (reference:
        bias_events_iterator.py:72-74).  Backends without programmable
        biases may ignore this."""

    @abc.abstractmethod
    def packets(self, delta_t: float) -> Iterator[np.ndarray]:
        """Yield structured EVENT_DTYPE chunks spanning ~delta_t us each,
        until the stream ends or the session is closed."""

    def close(self) -> None:
        pass


class CaptureBackend(abc.ABC):
    """Factory for capture sessions of one camera family."""

    #: registry key, e.g. "metavision"
    name: str = ""

    @abc.abstractmethod
    def open(self, serial: str = "", **hints) -> CaptureSession:
        """Open a camera ("" = first available).  ``hints`` carry app
        expectations a hardware-less backend may honor (camera_width,
        camera_height, projector_fps); real hardware reports its own."""


_REGISTRY: Dict[str, CaptureBackend] = {}


def register_capture_backend(backend: CaptureBackend) -> None:
    assert backend.name, "backend must set a registry name"
    _REGISTRY[backend.name] = backend


def capture_backends() -> Dict[str, CaptureBackend]:
    return dict(_REGISTRY)


def open_capture(
    spec: str = "",
    bias_file: Optional[str] = None,
    **hints,
) -> CaptureSession:
    """Open a live capture session.

    ``spec`` is ``"backend"`` or ``"backend:serial"``; empty picks the
    ``XMAPS_CAPTURE_BACKEND`` env var, then the sole registered hardware
    backend (``synthetic`` is only chosen when explicitly named).
    """
    spec = spec or os.environ.get("XMAPS_CAPTURE_BACKEND", "")
    name, _, serial = spec.partition(":")
    if not name:
        hw = [n for n in _REGISTRY if n != "synthetic"]
        if len(hw) == 1:
            name = hw[0]
        else:
            raise RuntimeError(
                "No capture backend selected. Pass --capture "
                "<backend[:serial]> or set XMAPS_CAPTURE_BACKEND. "
                f"Registered: {sorted(_REGISTRY) or '(none)'}"
            )
    if name not in _REGISTRY:
        raise RuntimeError(
            f"Unknown capture backend '{name}'. "
            f"Registered: {sorted(_REGISTRY) or '(none)'}"
        )
    session = _REGISTRY[name].open(serial, **hints)
    if bias_file:
        session.set_biases(load_bias_file(bias_file))
    return session


class LiveEventsIterator:
    """FileEventsIterator-shaped adapter over a live CaptureSession, so the
    runtime (packetize -> filters -> trigger finder) is source-agnostic."""

    def __init__(self, session: CaptureSession, delta_t: float):
        self.session = session
        self.delta_t = float(delta_t)

    def get_size(self) -> tuple[int, int]:
        return self.session.get_size()

    def __iter__(self) -> Iterator[np.ndarray]:
        return self.session.packets(self.delta_t)


class _SyntheticSession(CaptureSession):
    def __init__(
        self,
        width,
        height,
        fps,
        depths,
        seed,
        duration_s,
        projector_width,
        projector_height,
        events_per_frame,
        calib_yaml=None,
    ):
        self.width, self.height = width, height
        self.fps = fps
        self.duration_s = duration_s
        self._closed = False

        from xmaps_tpu_torch.utils.synthetic import (
            make_synthetic_calibration,
            simulate_sequence,
        )

        if calib_yaml:
            # simulate through the app's actual rig so the depth output
            # is meaningful, not just structurally valid
            from xmaps_tpu_torch.calib.maps import CalibrationParams

            calib = CalibrationParams.from_yaml(
                calib_yaml, width, height, projector_width, projector_height
            )
        else:
            calib = make_synthetic_calibration(
                camera_width=width,
                camera_height=height,
                projector_width=projector_width,
                projector_height=projector_height,
            )
        # density chosen so each frame clears the trigger finder's
        # MIN_EVENTS_PER_FRAME regardless of sensor scale
        subsample = min(
            0.85, max(1500, events_per_frame) / float(width * height)
        )
        self._events = simulate_sequence(
            calib,
            depths,
            fps=fps,
            subsample=subsample,
            rng=np.random.default_rng(seed),
        )

    def get_size(self) -> tuple[int, int]:
        return self.height, self.width

    def set_biases(self, biases) -> None:
        # no sensor registers; recorded so tests can assert the plumbing
        self.programmed_biases = dict(biases)

    def packets(self, delta_t: float) -> Iterator[np.ndarray]:
        """Wall-clock-paced replay of the synthesized frames, looping
        until ``duration_s`` elapses (0 = one pass)."""
        evs = self._events
        t0_ev = int(evs["t"][0])
        span = int(evs["t"][-1]) - t0_ev + int(delta_t)
        wall0 = time.perf_counter()
        epoch = 0
        while not self._closed:
            t_next = t0_ev + delta_t
            start = 0
            while start < len(evs):
                cut = int(
                    np.searchsorted(evs["t"], t_next, side="left")
                )
                pkt = evs[start:cut].copy()
                pkt["t"] += epoch * span
                due = (epoch * span + t_next - t0_ev) / 1e6
                lag = due - (time.perf_counter() - wall0)
                if lag > 0:
                    time.sleep(lag)
                yield pkt
                if self._closed or (
                    self.duration_s
                    and time.perf_counter() - wall0 >= self.duration_s
                ):
                    return
                start = cut
                t_next += delta_t
            if not self.duration_s:
                return
            epoch += 1

    def close(self) -> None:
        self._closed = True


class SyntheticCaptureBackend(CaptureBackend):
    """Hardware-less live source: synthesizes a scanning-projector event
    stream at the projector rate and delivers it in real time.  The
    in-tree proof that the capture seam is implementable end-to-end."""

    name = "synthetic"

    def open(self, serial: str = "", **hints) -> CaptureSession:
        return _SyntheticSession(
            width=int(hints.get("camera_width", 640)),
            height=int(hints.get("camera_height", 480)),
            fps=int(hints.get("projector_fps", 60)),
            depths=hints.get("depths", [0.45 + 0.03 * i for i in range(8)]),
            seed=int(serial) if serial else 21,
            duration_s=float(hints.get("duration_s", 0.0)),
            projector_width=int(hints.get("projector_width", 720)),
            projector_height=int(hints.get("projector_height", 1280)),
            events_per_frame=int(hints.get("events_per_frame", 20000)),
            calib_yaml=hints.get("calib_yaml"),
        )


register_capture_backend(SyntheticCaptureBackend())

# the Metavision HAL adapter joins the registry when the SDK is present
# (plain import: the module self-registers, which stays correct even if
# it is imported first and this import resolves mid-initialization)
import xmaps_tpu_torch.io.capture_metavision  # noqa: E402,F401
