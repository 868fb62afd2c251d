"""Calibration YAML readers for both dialects used by the reference.

1. The X-maps dialect (reference: cam_proj_calibration.py:17-28,77-108):
   plain YAML where each matrix is a mapping with ``type-id: opencv_matrix``,
   ``rows``, ``cols``, ``data``.
2. The ESL dialect (reference: cam_proj_calibration.py:110-140): an OpenCV
   FileStorage YAML (``%YAML:1.0`` header, ``!!opencv-matrix`` tags) with
   keys cam_K, cam_kc, proj_K, proj_kc, R, T.  The reference reads it with
   cv2.FileStorage; we parse it standalone.

Copy of ``xmaps_tpu.calib.cv_yaml`` with a lazy ``yaml`` import.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["load_cv_yaml", "read_cv_matrix"]


def _opencv_matrix_constructor(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    return mapping


def load_cv_yaml(path: str) -> dict:
    """Load a calibration YAML file of either dialect into a plain dict.

    Handles the OpenCV FileStorage quirks: the ``%YAML:1.0`` directive and
    ``!!opencv-matrix`` tags (converted to plain mappings).  ``yaml`` is
    imported here, not at module top: PyTorch does not depend on pyyaml,
    and synthetic rigs never read a file.
    """
    import yaml

    class _CvLoader(yaml.SafeLoader):
        pass

    _CvLoader.add_constructor(
        "tag:yaml.org,2002:opencv-matrix", _opencv_matrix_constructor
    )
    with open(path, "r") as f:
        text = f.read()
    # Strip FileStorage directives pyyaml chokes on.
    text = re.sub(r"^%YAML[^\n]*\n(---[^\n]*\n)?", "", text)
    # Some FileStorage writers emit "key: !!opencv-matrix" on one line.
    return yaml.load(text, Loader=_CvLoader)


def read_cv_matrix(calibration_data: dict, name: str) -> np.ndarray:
    """Read an OpenCV-style matrix entry from a parsed calibration dict.

    Accepts both the explicit ``type-id: opencv_matrix`` form of the X-maps
    dialect (reference: cam_proj_calibration.py:17-28) and the tagged
    FileStorage form (where the tag was already erased by the loader).
    """
    entry = calibration_data.get(name)
    if (
        isinstance(entry, dict)
        and "rows" in entry
        and "cols" in entry
        and "data" in entry
        and (entry.get("type-id", "opencv_matrix") == "opencv_matrix")
    ):
        return np.array(entry["data"], dtype=np.float64).reshape(
            entry["rows"], entry["cols"]
        )
    raise ValueError(f"Could not read matrix {name} from calibration data")
