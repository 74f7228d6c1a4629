"""Small IO helpers (``istnet_tpu/utils/io.py``; the reference's
``utils/common_utils.py``)."""

from __future__ import annotations

import numpy as np


def write_obj(points: np.ndarray, path: str) -> None:
    """Dump an (N, 3) point cloud as a Wavefront .obj vertex list
    (common_utils.py:5-11)."""
    with open(path, "w") as f:
        for p in np.asarray(points).reshape(-1, 3):
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
