"""ImageNet normalisation (counterpart of ``istnet_tpu/data/transforms.py``;
the PIL colour jitter belongs to the train data path and is not here yet)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> channel-last float32, ImageNet-normalised."""
    return ((rgb.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD
