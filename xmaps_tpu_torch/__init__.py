"""xmaps_tpu_torch: the per-frame event->depth engine in PyTorch + CUDA.

A port of ``xmaps_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  The
JAX package stays the reference; this package mirrors its module names and
imports nothing of it, so it runs on a machine without JAX.

- ``xmaps_tpu_torch.calib``  -- one-time host calibration math (NumPy),
  copied from ``xmaps_tpu.calib``.
- ``xmaps_tpu_torch.ops``    -- per-frame tensor code and the three CUDA
  kernels (``csrc/``): per-event rectify + X-map gather + scatter, the
  projector-view dense tail, the camera-view colorize.
- ``xmaps_tpu_torch.models`` -- ``XMapsDepthEngine``.

There is no device auto-pick: every entry point takes an explicit
``device``.  A CPU tensor runs the plain PyTorch version of each kernel; a
CUDA tensor launches the kernel or raises.
"""

__version__ = "0.1.0"
