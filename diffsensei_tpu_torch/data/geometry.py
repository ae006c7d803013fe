"""Copy of the PIL helpers of ``diffsensei_tpu/data/geometry.py`` (PIL
only), so the port needs nothing of the JAX package.

Panel resizing to a bucket (returning the crop offset for SDXL's
micro-conditioning), the square pad and its inverse, relative and page
bboxes, character crops from relative bboxes, dialog white-out, the
right-to-left reading order and the character crop flip
(``src/datasets/utils.py:188-381`` in the reference).
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


def resize_and_pad(image: Image.Image, target_size: int = 1024) -> Image.Image:
    """Longest-edge resize, then a white pad to a square."""
    image = image.copy()
    image.thumbnail((target_size, target_size), Image.BICUBIC)
    w, h = image.size
    pad_w = (target_size - w) // 2 if w < target_size else 0
    pad_h = (target_size - h) // 2 if h < target_size else 0
    out = Image.new("RGB", (target_size, target_size), (255, 255, 255))
    out.paste(image, (pad_w, pad_h))
    return out


def center_crop_and_resize(image: Image.Image, original_width: int,
                           original_height: int) -> Image.Image:
    """Undo ``resize_and_pad``: crop the padding, then restore the original
    size."""
    w, h = image.size
    aspect = original_width / original_height
    if original_width > original_height:
        new_h = int(w / aspect)
        pad = (h - new_h) // 2
        cropped = image.crop((0, pad, w, h - pad))
    else:
        new_w = int(h * aspect)
        pad = (w - new_w) // 2
        cropped = image.crop((pad, 0, w - pad, h))
    return cropped.resize((original_width, original_height), Image.BICUBIC)


def get_relative_bbox(bbox_bg: Sequence[float], bbox_fg: Sequence[float]) -> List[float]:
    """``bbox_fg`` in ``bbox_bg``-relative [0, 1] coordinates."""
    bx1, by1, bx2, by2 = bbox_bg
    fx1, fy1, fx2, fy2 = bbox_fg
    w, h = bx2 - bx1, by2 - by1
    return [(fx1 - bx1) / w, (fy1 - by1) / h, (fx2 - bx1) / w, (fy2 - by1) / h]


def get_page_bbox(frame_bbox: Sequence[float], frame_info: Dict) -> List[float]:
    """A frame-relative pixel bbox on the page."""
    x1, y1, x2, y2 = frame_bbox
    fx1, fy1, _, _ = frame_info["bbox"]
    return [x1 + fx1, y1 + fy1, x2 + fx1, y2 + fy1]


def get_page_bbox_from_rel_bbox(rel_bbox: Sequence[float],
                                frame_bbox: Sequence[float]) -> List[int]:
    """A [0, 1] frame-relative bbox as rounded page pixels."""
    x1, y1, x2, y2 = frame_bbox
    rx1, ry1, rx2, ry2 = rel_bbox
    w, h = x2 - x1, y2 - y1
    return [round(x1 + rx1 * w), round(y1 + ry1 * h),
            round(x1 + rx2 * w), round(y1 + ry2 * h)]


def get_cropped_ip_images_from_relative_bbox(
        image: Image.Image, relative_bbox: Sequence[Sequence[float]]) -> List[Image.Image]:
    """The characters cropped out of a panel by relative bboxes, clamped to
    the image."""
    w, h = image.size
    crops = []
    for rx1, ry1, rx2, ry2 in relative_bbox:
        x1 = max(0, min(int(rx1 * w), w))
        y1 = max(0, min(int(ry1 * h), h))
        x2 = max(0, min(int(rx2 * w), w))
        y2 = max(0, min(int(ry2 * h), h))
        crops.append(image.crop((x1, y1, x2, y2)))
    return crops


def mask_dialogs_from_image(image: Image.Image, ann: Dict) -> Image.Image:
    """White-out every dialog bbox of the page."""
    draw = ImageDraw.Draw(image)
    for frame_info in ann["frames"]:
        for dialog in frame_info["dialogs"]:
            draw.rectangle(list(dialog["bbox"]), fill="white")
    return image


def sort_manga_panels(ann: Dict, width: int, threshold: int = 100) -> List[Dict]:
    """The frames in manga reading order: the left half of the page, then the
    right (the reference's split), each top to bottom in soft rows of
    ``threshold`` pixels and right to left within a row."""
    left, right = [], []
    for frame in ann["frames"]:
        (left if frame["bbox"][0] < width / 2 - threshold else right).append(frame)

    def key(frame):
        x1, y1, _, _ = frame["bbox"]
        return (round(y1 / threshold), -x1)

    return sorted(left, key=key) + sorted(right, key=key)


def maybe_flip(image: Image.Image, flip: bool) -> Image.Image:
    return ImageOps.mirror(image) if flip else image
