"""Image transforms on the host: the PIL colour jitter and ImageNet
normalisation (counterpart of ``istnet_tpu/data/transforms.py``).

``color_jitter`` is torchvision's ``ColorJitter(0.2, 0.2, 0.2, 0.05)`` on
the PIL ImageEnhance backend, as the reference's train dataset applies it:
the four factors drawn uniformly in the order brightness, contrast,
saturation, hue, then the ops applied in ``rng.permutation`` order, so that
the same ``RandomState`` gives the JAX package's pixels.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def color_jitter(rgb: np.ndarray, rng: np.random.RandomState,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2, hue: float = 0.05) -> np.ndarray:
    """(H, W, 3) uint8 -> jittered uint8, torchvision ColorJitter semantics."""
    img = Image.fromarray(rgb)
    ops = []
    if brightness > 0:
        f = rng.uniform(1 - brightness, 1 + brightness)
        ops.append(lambda im, f=f: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f = rng.uniform(1 - contrast, 1 + contrast)
        ops.append(lambda im, f=f: ImageEnhance.Contrast(im).enhance(f))
    if saturation > 0:
        f = rng.uniform(1 - saturation, 1 + saturation)
        ops.append(lambda im, f=f: ImageEnhance.Color(im).enhance(f))
    if hue > 0:
        f = rng.uniform(-hue, hue)

        def hue_shift(im, f=f):
            h, s, v = im.convert("HSV").split()
            h = h.point(lambda px: (px + int(f * 255)) % 256)
            return Image.merge("HSV", (h, s, v)).convert("RGB")

        ops.append(hue_shift)
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return np.asarray(img, np.uint8)


def normalize_image(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> channel-last float32, ImageNet-normalised."""
    return ((rgb.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD
