"""Evaluation and inference datasets: per-frame items for generation-time
eval (port of ``diffsensei_tpu/data/eval_dataset.py``).

Each item carries what the pipeline needs to regenerate a panel: the frame
size snapped to the bucket grid (or floored to a multiple of 8 with
``snap=False``), the biggest characters first, each character's source crop
drawn from the page's frames with ``random.Random`` exactly as the JAX
package draws it, the dialog bboxes, and the raw annotations for metrics
(the reference's ``MangaEvaluationDataset`` and the MLLM eval and inference
variants). ``MangaInferenceCharImageDataset`` takes its characters from a
directory of reference images instead.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

from PIL import Image

from diffsensei_tpu_torch.core.buckets import snap_to_bucket
from diffsensei_tpu_torch.data import geometry
from diffsensei_tpu_torch.data.mllm_dataset import MLLMTokenSpec, build_inference_prompt


class MangaEvaluationDataset:
    """Per-frame eval items for the wo-MLLM pipeline (``annotations`` given
    in memory, or read from ``ann_path``; a page's ``"image"`` entry, a PIL
    image, stands in for its file)."""

    def __init__(self, ann_path: Optional[str], image_root: str,
                 max_num_ips: int = 4, max_num_dialogs: int = 8,
                 mask_dialog: bool = False,
                 min_ip_height: int = 0, min_ip_width: int = 0,
                 annotations: Optional[List[Dict]] = None,
                 rng: Optional[random.Random] = None,
                 snap: bool = True):
        if annotations is None:
            with open(ann_path) as f:
                annotations = json.load(f)
        self.annotations = annotations
        self.image_root = image_root
        self.max_num_ips = max_num_ips
        self.max_num_dialogs = max_num_dialogs
        self.mask_dialog = mask_dialog
        self.min_ip_height = min_ip_height
        self.min_ip_width = min_ip_width
        self.rng = rng or random.Random(0)
        self.snap = snap
        self.items: List[Dict] = [{"ann": ann, "frame_idx": frame_idx}
                                  for ann in self.annotations
                                  for frame_idx, _ in enumerate(ann["frames"])]

    def __len__(self):
        return len(self.items)

    def _page_image(self, ann: Dict) -> Image.Image:
        if "image" in ann:
            page_image = ann["image"].convert("RGB")
        else:
            page_image = Image.open(os.path.join(self.image_root, ann["image_path"])).convert("RGB")
        if self.mask_dialog:
            page_image = geometry.mask_dialogs_from_image(page_image, ann)
        return page_image

    def _frame_size(self, frame_info: Dict) -> Tuple[int, int]:
        """(height, width) of the frame on the bucket grid, or floored to a
        multiple of 8."""
        x1, y1, x2, y2 = frame_info["bbox"]
        height, width = y2 - y1, x2 - x1
        if self.snap:
            return snap_to_bucket(height, width)
        return (height // 8) * 8, (width // 8) * 8

    @staticmethod
    def _biggest_first(frame_info: Dict) -> List[Dict]:
        return sorted(frame_info["characters"],
                      key=lambda c: (c["bbox"][2] - c["bbox"][0]) * (c["bbox"][3] - c["bbox"][1]),
                      reverse=True)

    def _support_ids(self, ann):
        """Character ids that appear more than once in some frame."""
        support = set()
        for frame in ann["frames"]:
            count: Dict[int, int] = {}
            for char in frame["characters"]:
                count[char["id"]] = count.get(char["id"], 0) + 1
            support.update(cid for cid, c in count.items() if c > 1)
        return support

    def __getitem__(self, idx: int) -> Dict:
        item = self.items[idx]
        ann, frame_idx = item["ann"], item["frame_idx"]
        frame_info = ann["frames"][frame_idx]
        page_image = self._page_image(ann)
        height, width = self._frame_size(frame_info)

        # biggest characters first; a source crop from any frame of the page
        support = self._support_ids(ann)
        ip_images, ip_bbox = [], []
        for char in self._biggest_first(frame_info):
            if char["id"] in support:
                continue
            sources = []
            for frame in ann["frames"]:
                for src in frame["characters"]:
                    sx1, sy1, sx2, sy2 = src["bbox"]
                    if (src["id"] == char["id"]
                            and (sy2 - sy1) > self.min_ip_height
                            and (sx2 - sx1) > self.min_ip_width
                            and src.get("type", 0) == 0):
                        sources.append(src["bbox"])
            if not sources:
                continue
            ip_images.append(page_image.crop(tuple(self.rng.choice(sources))))
            ip_bbox.append(geometry.get_relative_bbox(frame_info["bbox"], char["bbox"]))
            if len(ip_images) >= self.max_num_ips:
                break

        dialog_bbox = [geometry.get_relative_bbox(frame_info["bbox"], d["bbox"])
                       for d in frame_info.get("dialogs", [])[: self.max_num_dialogs]]
        return {
            "caption": frame_info.get("caption", ""),
            "height": height,
            "width": width,
            "ip_images": ip_images,            # PIL; the pipeline preprocesses them
            "ip_bbox": ip_bbox,
            "dialog_bbox": dialog_bbox,
            "frame_info": frame_info,
            "ann": ann,
        }


class MangaEvalMLLMDataset(MangaEvaluationDataset):
    """Eval items plus the MLLM inference prompt of the caption
    (``build_inference_prompt``: ``input_ids`` and the ``ids_cmp_mask`` of
    the source characters' slots)."""

    def __init__(self, *args, mllm_spec: MLLMTokenSpec, **kwargs):
        super().__init__(*args, **kwargs)
        self.mllm_spec = mllm_spec
        self._newline = list(mllm_spec.encode_text("\n"))

    def __getitem__(self, idx: int) -> Dict:
        item = super().__getitem__(idx)
        caption_ids = self.mllm_spec.encode_text(item["caption"])
        item.update(build_inference_prompt(caption_ids, self.mllm_spec, self._newline))
        return item


class MangaInferenceMLLMDataset(MangaEvalMLLMDataset):
    """Per-frame MLLM inference items with the source characters cached per
    page: the page's first frame draws one source bbox per character id
    (``sample_source_characters``) and every later frame of the page reuses
    that crop, so a character looks the same across the page's panels.

    Items add ``condition_ip_bbox`` (the source crops' page bboxes), shuffle
    the dialogs with the dataset's ``rng`` and cut captions to
    ``max_caption_length`` tokens."""

    def __init__(self, *args, max_caption_length: int = 77, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_caption_length = max_caption_length
        self._page_source_chars: Dict = {}
        self._ann_index = {id(a): i for i, a in enumerate(self.annotations)}

    def _page_key(self, ann) -> str:
        """The page's image path, or its index among the annotations."""
        if ann.get("image_path"):
            return ann["image_path"]
        return f"ann-{self._ann_index[id(ann)]}"

    def sample_source_characters(self, ann):
        """``(char_ids, char_bboxes)``: one source bbox drawn per character id
        of the page, cached."""
        key = self._page_key(ann)
        if key in self._page_source_chars:
            cached = self._page_source_chars[key]
            return cached["char_ids"], cached["char_bboxes"]
        char_boxes: Dict = {}
        for frame in ann["frames"]:
            for char in frame["characters"]:
                x1, y1, x2, y2 = char["bbox"]
                if ((y2 - y1) > self.min_ip_height and (x2 - x1) > self.min_ip_width
                        and char.get("type", 0) == 0):
                    char_boxes.setdefault(char["id"], []).append(char["bbox"])
        char_ids = list(char_boxes)
        char_bboxes = [self.rng.choice(b) for b in char_boxes.values()]
        self._page_source_chars[key] = {"char_ids": char_ids, "char_bboxes": char_bboxes}
        return char_ids, char_bboxes

    def __getitem__(self, idx: int) -> Dict:
        item = self.items[idx]
        ann, frame_idx = item["ann"], item["frame_idx"]
        frame_info = ann["frames"][frame_idx]
        page_image = self._page_image(ann)
        height, width = self._frame_size(frame_info)

        source_ids, source_bboxes = self.sample_source_characters(ann)
        ip_images, ip_bbox, condition_ip_bbox = [], [], []
        for char in self._biggest_first(frame_info):
            if char["id"] not in source_ids:
                continue
            cx1, cy1, cx2, cy2 = char["bbox"]
            if (cy2 - cy1) <= self.min_ip_height or (cx2 - cx1) <= self.min_ip_width:
                continue
            src_bbox = source_bboxes[source_ids.index(char["id"])]
            condition_ip_bbox.append(src_bbox)
            ip_images.append(page_image.crop(tuple(src_bbox)))
            ip_bbox.append(geometry.get_relative_bbox(frame_info["bbox"], char["bbox"]))
            if len(ip_bbox) >= self.max_num_ips:
                break

        dialogs = frame_info.get("dialogs", [])
        order = list(range(len(dialogs)))
        self.rng.shuffle(order)
        dialog_bbox = [geometry.get_relative_bbox(frame_info["bbox"], dialogs[i]["bbox"])
                       for i in order[: self.max_num_dialogs]]

        caption = frame_info.get("caption", "")
        caption_ids = list(self.mllm_spec.encode_text(caption))[: self.max_caption_length]
        out = {
            "caption": caption,
            "height": height,
            "width": width,
            "ip_images": ip_images,
            "ip_bbox": ip_bbox,
            "condition_ip_bbox": condition_ip_bbox,
            "dialog_bbox": dialog_bbox,
            "frame_info": frame_info,
            "ann": ann,
        }
        out.update(build_inference_prompt(caption_ids, self.mllm_spec, self._newline))
        return out


class MangaInferenceCharImageDataset:
    """Characters from a directory of reference images: each item is a prompt
    spec (``{"caption", "character_images": [file, ...], "ip_bbox",
    "dialog_bbox", "height", "width"}``) with up to ``max_num_ips`` of its
    character images opened as ``ip_images``; with ``mllm_spec`` also the
    MLLM prompt of the caption, cut to ``max_caption_length`` tokens."""

    def __init__(self, prompts: List[Dict], char_image_root: str,
                 max_num_ips: int = 4,
                 mllm_spec: Optional[MLLMTokenSpec] = None,
                 max_caption_length: int = 77):
        self.prompts = prompts
        self.root = char_image_root
        self.max_num_ips = max_num_ips
        self.mllm_spec = mllm_spec
        self.max_caption_length = max_caption_length
        self._newline = list(mllm_spec.encode_text("\n")) if mllm_spec else []

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, idx: int) -> Dict:
        spec = dict(self.prompts[idx])
        spec["ip_images"] = [Image.open(os.path.join(self.root, name)).convert("RGB")
                             for name in spec.get("character_images", [])[: self.max_num_ips]]
        if self.mllm_spec is not None:
            caption_ids = list(self.mllm_spec.encode_text(
                spec.get("caption", "")))[: self.max_caption_length]
            spec.update(build_inference_prompt(caption_ids, self.mllm_spec, self._newline))
        return spec
