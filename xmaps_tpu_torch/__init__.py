"""xmaps_tpu_torch: the event->depth system in PyTorch + CUDA.

A port of ``xmaps_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  The
JAX package stays the reference; this package mirrors its module names and
imports nothing of it, so it runs on a machine without JAX.

- ``xmaps_tpu_torch.calib``  -- one-time host calibration math (NumPy),
  copied from ``xmaps_tpu.calib``.
- ``xmaps_tpu_torch.ops``    -- per-frame tensor code and the CUDA kernels
  (``csrc/``): per-event rectify + X-map gather + scatter, the
  projector-view dense tail, the camera-view colorize, the ESL search, the
  static remap and the bench's warm-up.
- ``xmaps_tpu_torch.models`` -- ``XMapsDepthEngine``.
- ``xmaps_tpu_torch.io``     -- EVT decoding (host C++), packet replay,
  stream filters, pinned staging.
- ``xmaps_tpu_torch.runtime`` -- trigger finder, watchdog, pipe, processor.
- ``xmaps_tpu_torch.parallel`` -- scale-out over a mesh of devices (data x
  event), one controller; a device may repeat (a virtual device).
- ``xmaps_tpu_torch.apps``   -- the replay app, the bench, the eval apps.

There is no device auto-pick: every entry point takes an explicit
``device``.  A CPU tensor runs the plain PyTorch version of each kernel; a
CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
