"""The SEED-X agent's token streams and the stage-3 dataset (port of
``diffsensei_tpu/data/mllm_dataset.py``, numpy and PIL only).

* ``MLLMTokenSpec``: the tokenizer-derived id constants and a text encoder.
* ``build_mllm_token_stream``: the supervised stream ``bos | caption \\n
  <img><img_0>..<img_{n-1}></img> \\n | <img>..</img> | eos`` with labels
  -100 over the instruction, the first image block's slots marked
  ``ids_cmp_mask`` (comprehension), the last's ``ids_gen_mask`` (generation,
  labels -100 inside), padded to ``max_token_length``; an overlong caption is
  truncated, so the stream's shape is fixed.
* ``MangaTrainMLLMDataset``: the stage-2 bucket sample plus the target
  character crops (the panel's own characters, the agent's reconstruction
  target, black-padded to ``max_num_ips``) and the stream, byte for byte the
  JAX package's.
* ``build_inference_prompt``: the serving prompt.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from diffsensei_tpu_torch.data import processors
from diffsensei_tpu_torch.data.bucket_dataset import MangaTrainSizeBucketDataset

NUM_LOC_TOKENS = 224


@dataclasses.dataclass(frozen=True)
class MLLMTokenSpec:
    """Tokenizer-derived id constants + a plain-text encoder."""

    bos_id: int
    eos_id: int
    pad_id: int
    boi_id: int
    eoi_id: int
    img_ids: Sequence[int]            # num_img_tokens ladder ids
    encode_text: Callable[[str], List[int]]   # no special tokens

    @property
    def num_img_tokens(self) -> int:
        return len(self.img_ids)

    @property
    def ladder_ids(self) -> np.ndarray:
        """[boi, img_0.., eoi] — the generation forcing table."""
        return np.asarray([self.boi_id, *self.img_ids, self.eoi_id], np.int64)


def relative_bbox_to_loc_tokens(rel_bbox: Sequence[float],
                                num_loc_tokens: int = NUM_LOC_TOKENS) -> str:
    """``<box_start><loc-k>...<box_end>`` serialization of a relative bbox
    (the reference keeps the helper; its final prompt does not use it)."""
    quant = [min(num_loc_tokens - 1, max(0, int(v * num_loc_tokens))) for v in rel_bbox]
    return "<box_start>" + "".join(f"<loc-{k}>" for k in quant) + "<box_end>"


def build_mllm_token_stream(caption_ids: List[int], spec: MLLMTokenSpec,
                            newline_ids: List[int],
                            max_token_length: int) -> Optional[Dict[str, np.ndarray]]:
    """The supervised stream of one sample; None if even an empty caption
    cannot fit."""
    n = spec.num_img_tokens
    block = [spec.boi_id, *spec.img_ids, spec.eoi_id]
    budget = max_token_length - (2 + 2 * len(block) + 2 * len(newline_ids))
    if budget < 0:
        return None
    caption_ids = list(caption_ids)[:budget]

    instruction = caption_ids + newline_ids + block + newline_ids
    input_ids = [spec.bos_id] + instruction + block + [spec.eos_id]
    labels = [-100] * (1 + len(instruction)) + block + [spec.eos_id]
    pad = max_token_length - len(input_ids)
    attention_mask = [1] * len(input_ids) + [0] * pad
    input_ids += [spec.pad_id] * pad
    labels = np.asarray(labels + [-100] * pad, np.int32)

    ids_cmp = np.zeros((max_token_length,), bool)
    ids_gen = np.zeros((max_token_length,), bool)
    first_block = 1 + len(caption_ids) + len(newline_ids)
    ids_cmp[first_block + 1: first_block + 1 + n] = True
    last_block = 1 + len(instruction)
    ids_gen[last_block + 1: last_block + 1 + n] = True
    labels[last_block + 1: last_block + 1 + n] = -100   # the rec slots: no LM target
    return {
        "mllm_input_ids": np.asarray(input_ids, np.int32),
        "mllm_attention_mask": np.asarray(attention_mask, np.int32),
        "mllm_labels": labels,
        "ids_cmp_mask": ids_cmp,
        "ids_gen_mask": ids_gen,
        "embeds_cmp_mask": np.asarray([True, False]),
        "embeds_gen_mask": np.asarray([False, True]),
    }


class MangaTrainMLLMDataset(MangaTrainSizeBucketDataset):
    """The bucket dataset's samples plus ``target_ip_pixel_values`` /
    ``target_magi_pixel_values`` ``[max_num_ips, 224, 224, 3]`` and the
    token stream of ``build_mllm_token_stream``."""

    def __init__(self, *args, mllm_spec: MLLMTokenSpec, max_token_length: int = 400,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.mllm_spec = mllm_spec
        self.max_token_length = max_token_length
        self._newline_ids = list(mllm_spec.encode_text("\n"))

    def _load_target_ip_images(self, page_bbox, page_image):
        clips, magis = [], []
        for k in range(self.cfg.max_num_ips):
            crop = (page_image.crop(tuple(page_bbox[k])) if k < len(page_bbox)
                    else Image.new("RGB", (224, 224), (0, 0, 0)))
            clips.append(processors.clip_preprocess(crop))
            magis.append(processors.vit_preprocess(crop))
        return np.stack(clips), np.stack(magis)

    def get_sample(self, bucket_key, sample_idx, rng):
        # the character draw after the bucket sample's, from the same generator
        sample = super().get_sample(bucket_key, sample_idx, rng)
        entry = self.buckets[bucket_key][sample_idx]
        ann = self.annotations[entry["ann_idx"]]
        frame_info = ann["frames"][entry["frame_idx"]]
        if "image" in ann:
            page_image = ann["image"].convert("RGB")
        else:
            page_image = Image.open(os.path.join(self.image_root,
                                                 ann["image_path"])).convert("RGB")
        _, _, page_bbox = self._sample_condition_characters(
            frame_info, self._support_ip_ids(ann), rng)
        sample["target_ip_pixel_values"], sample["target_magi_pixel_values"] = \
            self._load_target_ip_images(page_bbox, page_image)
        stream = build_mllm_token_stream(self.mllm_spec.encode_text(frame_info.get("caption", "")),
                                         self.mllm_spec, self._newline_ids,
                                         self.max_token_length)
        if stream is None:
            raise ValueError(f"max_token_length {self.max_token_length} is too small for "
                             "the stream's template")
        sample.update(stream)
        return sample


def build_inference_prompt(caption_ids: List[int], spec: MLLMTokenSpec,
                           newline_ids: List[int]) -> Dict[str, np.ndarray]:
    """Serving prompt (reference ``scripts/demo/gradio.py:36-57``):
    ``bos ‖ caption \\n <img><img_0..n></img> \\n <img>`` — the comprehension
    block carries the source characters; the trailing ``<img>`` triggers the
    forced generation ladder."""
    block = [spec.boi_id, *spec.img_ids, spec.eoi_id]
    ids = [spec.bos_id] + list(caption_ids) + newline_ids + block \
        + newline_ids + [spec.boi_id]
    ids = np.asarray(ids, np.int32)
    cmp_mask = np.zeros(ids.shape, bool)
    start = 1 + len(caption_ids) + len(newline_ids) + 1
    cmp_mask[start: start + spec.num_img_tokens] = True
    return {"input_ids": ids[None], "ids_cmp_mask": cmp_mask[None]}
