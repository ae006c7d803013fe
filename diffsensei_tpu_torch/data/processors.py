"""Copy of ``diffsensei_tpu/data/processors.py`` (numpy and PIL only), so the
port needs nothing of the JAX package.

CPU-side image preprocessing producing NHWC numpy arrays.

Replaces the HF processors the reference instantiates per-dataset
(``CLIPImageProcessor`` / ``ViTImageProcessor``, ``dataset_size_bucket.py:74-75``)
with numpy/PIL equivalents that emit the TPU layout directly:

* ``clip_preprocess``  — shortest-side 224 bicubic resize, center crop 224²,
  CLIP mean/std normalization (the CLIPImageProcessor defaults);
* ``vit_preprocess``   — direct 224² resize, 0.5/0.5 normalization (the
  ViTImageProcessor defaults Magi uses);
* ``panel_transform``  — panel pixels → [-1, 1] (the diffusers VAE convention).

All return float32 [H, W, 3] (NHWC, channels last on the 128-lane axis).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from PIL import Image

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
VIT_MEAN = np.asarray([0.5, 0.5, 0.5], np.float32)
VIT_STD = np.asarray([0.5, 0.5, 0.5], np.float32)


def _to_float(image: Image.Image) -> np.ndarray:
    return np.asarray(image.convert("RGB"), np.float32) / 255.0


def clip_preprocess(image: Image.Image, size: int = 224) -> np.ndarray:
    w, h = image.size
    if w == 0 or h == 0:  # corrupt/empty crop → black (reference fallback,
        return np.zeros((size, size, 3), np.float32)  # dataset_size_bucket.py:186-202)
    if w < h:
        new_w, new_h = size, max(1, int(round(h * size / w)))
    else:
        new_w, new_h = max(1, int(round(w * size / h))), size
    image = image.resize((new_w, new_h), Image.BICUBIC)
    left = (new_w - size) // 2
    top = (new_h - size) // 2
    image = image.crop((left, top, left + size, top + size))
    arr = _to_float(image)
    return (arr - CLIP_MEAN) / CLIP_STD


def vit_preprocess(image: Image.Image, size: int = 224) -> np.ndarray:
    if image.size[0] == 0 or image.size[1] == 0:
        return np.zeros((size, size, 3), np.float32)
    arr = _to_float(image.resize((size, size), Image.BICUBIC))
    return (arr - VIT_MEAN) / VIT_STD


def panel_transform(image: Image.Image) -> np.ndarray:
    """Panel → [-1, 1] float32 NHWC (torchvision Normalize(0.5, 0.5) equiv)."""
    return _to_float(image) * 2.0 - 1.0


def batch_clip(images: Sequence[Image.Image]) -> np.ndarray:
    return np.stack([clip_preprocess(im) for im in images])


def batch_vit(images: Sequence[Image.Image]) -> np.ndarray:
    return np.stack([vit_preprocess(im) for im in images])
