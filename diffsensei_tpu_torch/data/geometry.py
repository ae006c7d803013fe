"""Copy of the PIL helpers of ``diffsensei_tpu/data/geometry.py`` that the
bucket dataset uses (PIL only), so the port needs nothing of the JAX package.

Panel resizing to a bucket (returning the crop offset for SDXL's
micro-conditioning), relative bboxes, dialog white-out and the character
crop flip (``src/datasets/utils.py:188-381`` in the reference). The page-level
helpers of the eval and serving datasets wait for those datasets.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from PIL import Image, ImageDraw, ImageOps


def resize_and_center_crop(image: Image.Image, bucket_size: Tuple[int, int]
                           ) -> Tuple[Image.Image, Tuple[int, int]]:
    """Aspect-preserving resize, then a center crop to ``(h, w)``; returns
    ``(image, (top, left))``, the offset of ``crop_coords_top_left``."""
    wa, ha = image.size
    hb, wb = bucket_size
    if ha / wa >= hb / wb:
        new_h, new_w = int(ha * wb / wa), wb
    else:
        new_h, new_w = hb, int(wa * hb / ha)
    resized = image.resize((new_w, new_h), Image.BICUBIC)
    left = (new_w - wb) // 2
    top = (new_h - hb) // 2
    return resized.crop((left, top, left + wb, top + hb)), (top, left)


def get_relative_bbox(bbox_bg: Sequence[float], bbox_fg: Sequence[float]) -> List[float]:
    """``bbox_fg`` in ``bbox_bg``-relative [0, 1] coordinates."""
    bx1, by1, bx2, by2 = bbox_bg
    fx1, fy1, fx2, fy2 = bbox_fg
    w, h = bx2 - bx1, by2 - by1
    return [(fx1 - bx1) / w, (fy1 - by1) / h, (fx2 - bx1) / w, (fy2 - by1) / h]


def mask_dialogs_from_image(image: Image.Image, ann: Dict) -> Image.Image:
    """White-out every dialog bbox of the page."""
    draw = ImageDraw.Draw(image)
    for frame_info in ann["frames"]:
        for dialog in frame_info["dialogs"]:
            draw.rectangle(list(dialog["bbox"]), fill="white")
    return image


def maybe_flip(image: Image.Image, flip: bool) -> Image.Image:
    return ImageOps.mirror(image) if flip else image
