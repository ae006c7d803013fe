"""The serving half of ``diffsensei_tpu/data/mllm_dataset.py``, copied: the
tokenizer-derived id constants of the SEED-X agent and its inference prompt.
The training stream and dataset wait for the training slice."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np


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
