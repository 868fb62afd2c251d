"""Metavision HAL capture backend (Prophesee cameras).

Copy of ``xmaps_tpu.io.capture_metavision`` (equal apart from its imports
and docstrings).  The adapter the capture registry (io/capture.py) was
designed for: it binds a live Prophesee sensor through the Metavision SDK
the same way the reference does (bias_events_iterator.py:66-90) -- HAL
device discovery by serial, bias-register programming via
``I_LL_Biases``, and delta_t-sized structured packets from
``EventsIterator`` -- and exposes it as a
:class:`~xmaps_tpu_torch.io.capture.CaptureSession`.

The backend registers itself only when the SDK imports
(:func:`register_metavision_backend` is called from io/capture's module
init); without it the module imports cleanly and registers nothing.  The
adapter logic is exercised against a faked SDK
(tests/test_torch_capture.py); on a machine with the real SDK and a
camera, ``python -m xmaps_tpu_torch.apps.depth_reprojection --capture
metavision[:serial]`` is the whole wiring.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from xmaps_tpu_torch.io.capture import (
    CaptureBackend,
    CaptureSession,
    register_capture_backend,
)
from xmaps_tpu_torch.io.evt_decoder import EVENT_DTYPE

__all__ = [
    "MetavisionCaptureBackend",
    "MetavisionSession",
    "register_metavision_backend",
]


class MetavisionSession(CaptureSession):
    """An open HAL device (reference: bias_events_iterator.py:66-90)."""

    def __init__(self, device):
        self.device = device
        self._closed = False
        geom = device.get_i_geometry()
        self._size = (int(geom.get_height()), int(geom.get_width()))

    def get_size(self) -> tuple[int, int]:
        return self._size

    def set_biases(self, biases: Dict[str, int]) -> None:
        # reference writes each .bias entry through I_LL_Biases
        # (bias_events_iterator.py:72-74); devices without programmable
        # biases report no facility and are left as-is
        ll = self.device.get_i_ll_biases()
        if ll is None:
            return
        for name, value in biases.items():
            ll.set(name, int(value))

    def packets(self, delta_t: float) -> Iterator[np.ndarray]:
        from metavision_core.event_io import EventsIterator

        # non-buffered delta_t slicing, as the reference's
        # NonBufferedBiasEventsIterator (bias_events_iterator.py:88-90)
        it = EventsIterator(
            input_path=self.device, delta_t=int(delta_t)
        )
        for evs in it:
            if self._closed:
                return
            out = np.zeros(len(evs), EVENT_DTYPE)
            if len(evs):
                # Metavision EventCD fields share our names; widths differ
                # (their t is i64 like ours, x/y u16, p i16)
                for f in ("x", "y", "p", "t"):
                    out[f] = evs[f]
            yield out

    def close(self) -> None:
        self._closed = True


class MetavisionCaptureBackend(CaptureBackend):
    name = "metavision"

    def open(self, serial: str = "", **hints) -> MetavisionSession:
        from metavision_hal import DeviceDiscovery

        device = DeviceDiscovery.open(serial)
        if device is None:
            raise RuntimeError(
                "No Prophesee camera found"
                + (f" for serial '{serial}'" if serial else "")
                + " (Metavision HAL DeviceDiscovery returned none)"
            )
        return MetavisionSession(device)


def register_metavision_backend(force: bool = False) -> bool:
    """Register the backend if the Metavision SDK is importable (or
    unconditionally with ``force``, for tests with a faked SDK).
    Returns whether the backend is registered."""
    if not force:
        try:
            import metavision_core.event_io  # noqa: F401
            import metavision_hal  # noqa: F401
        except ImportError:
            return False
    register_capture_backend(MetavisionCaptureBackend())
    return True


register_metavision_backend()
