"""One-time host-side calibration math (NumPy, OpenCV-compatible).

Copies of ``xmaps_tpu.calib.{geometry,rectify,maps,cv_yaml}`` so that the
port needs nothing of the JAX package; ``yaml`` is imported only when a
calibration file is read.  tests/test_torch_calib.py pins every
``CamProjMaps`` array equal to the JAX package's.
"""

from xmaps_tpu_torch.calib.maps import (  # noqa: F401
    CalibrationParams,
    CamProjMaps,
    map_f32_to_i16,
)
