"""MangaZero bucketed training dataset (port of
``diffsensei_tpu/data/bucket_dataset.py``, numpy and PIL only).

The reference's ``MangaTrainSizeBucketDataset`` + ``BucketBatchSampler`` +
``collate_fn`` (``src/datasets/dataset_size_bucket.py:23,488,303``) as the JAX
package rebuilt them: every bucket's batch has a fixed size (the per-class
scaled size, ``batch_size / 4^size_index``), partial final batches are padded
with repeated samples and a ``sample_mask`` that masks the loss, and batches
are NHWC numpy. Augmentation draws come from a per-sample
``Random(epoch seed, bucket, index)``, so the stream is the JAX package's,
byte for byte, for any worker count.

Data parallelism: a bucket's batch is the per-rank size times
``data_parallel``, and every rank walks the same epoch plan and takes rows
``[host_id::num_hosts]`` of each global batch (the sampler sharding
Accelerate does for the reference). ``load_context_image`` adds a random
other frame of the page as a context image, blacked out with
``c_drop_rate`` (the reference's ``dataset_size_bucket.py:264-272``).

Annotation schema (MangaZero): a JSON list of pages, each
``{"image_path": str, "frames": [{"bbox": [x1,y1,x2,y2], "caption": str,
"characters": [{"id": int, "bbox": [...], "type": 0|1}],
"dialogs": [{"bbox": [...]}]}]}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image

from diffsensei_tpu_torch.core.buckets import SIZE_BUCKETS, get_bucket_size
from diffsensei_tpu_torch.data import geometry, processors


@dataclasses.dataclass
class BucketDatasetConfig:
    t_drop_rate: float = 0.05        # caption CFG dropout
    i_drop_rate: float = 0.05        # per-character dropout
    c_drop_rate: float = 0.05        # context-image dropout
    max_num_ips: int = 4
    max_num_ip_sources: int = 1
    max_num_dialogs: int = 8
    mask_dialog: bool = False
    load_context_image: bool = False
    ip_self_condition_rate: float = 0.5
    ip_flip_rate: float = 0.5
    min_ip_height: int = 5
    min_ip_width: int = 5
    batch_size: int = 8              # per-rank base size; each size class scales it by 1/4
    data_parallel: int = 1           # ranks on the data axis; global batch = per-rank x this


class MangaTrainSizeBucketDataset:
    """Page-level annotations -> per-frame samples partitioned into buckets."""

    def __init__(self, ann_path: str, image_root: str,
                 tokenize: Callable[[str], np.ndarray],
                 tokenize_2: Optional[Callable[[str], np.ndarray]] = None,
                 config: BucketDatasetConfig = BucketDatasetConfig(),
                 annotations: Optional[List[Dict]] = None):
        if annotations is None:
            with open(ann_path) as f:
                annotations = json.load(f)
        self.annotations = annotations
        self.image_root = image_root
        self.tokenize = tokenize
        self.tokenize_2 = tokenize_2 or tokenize
        self.cfg = config

        self.buckets: Dict[Tuple[int, int], List[Dict]] = {}
        self.bucket_size_index: Dict[Tuple[int, int], int] = {}
        for ann_idx, ann in enumerate(self.annotations):
            for frame_idx, frame in enumerate(ann["frames"]):
                w = frame["bbox"][2] - frame["bbox"][0]
                h = frame["bbox"][3] - frame["bbox"][1]
                bh, bw, size_idx = get_bucket_size(h, w, SIZE_BUCKETS)
                self.buckets.setdefault((bh, bw), []).append(
                    {"ann_idx": ann_idx, "frame_idx": frame_idx})
                self.bucket_size_index[(bh, bw)] = size_idx
        self.bucket_keys = list(self.buckets.keys())

    def __len__(self):
        return sum(len(v) for v in self.buckets.values())

    # -- character sampling (reference :94-204) --------------------------------
    @staticmethod
    def _support_ip_ids(ann) -> List[int]:
        """Character ids that appear more than once within one frame (ambiguous
        identity, excluded from conditioning)."""
        support = set()
        for frame in ann["frames"]:
            count: Dict[int, int] = {}
            for char in frame["characters"]:
                count[char["id"]] = count.get(char["id"], 0) + 1
            support.update(cid for cid, c in count.items() if c > 1)
        return list(support)

    def _sample_condition_characters(self, frame_info, support_ids, rng):
        cfg = self.cfg
        ids, bbox, page_bbox = [], [], []
        frame_bbox = frame_info["bbox"]
        for idx in rng.sample(range(len(frame_info["characters"])),
                              len(frame_info["characters"])):
            char = frame_info["characters"][idx]
            if char["id"] in support_ids or rng.random() < cfg.i_drop_rate:
                continue
            ids.append(char["id"])
            bbox.append(geometry.get_relative_bbox(frame_bbox, char["bbox"]))
            page_bbox.append(char["bbox"])
            if len(ids) >= cfg.max_num_ips:
                break
        while len(ids) < cfg.max_num_ips:
            ids.append(-1)
            bbox.append([0.0, 0.0, 0.0, 0.0])
        return ids, bbox, page_bbox

    def _load_ip_images(self, ann, ids, page_bbox, page_image, rng):
        """Per character up to ``max_num_ip_sources`` crops from any frame of
        the page (the frame's own crop first with ``ip_self_condition_rate``),
        a random flip, CLIP and Magi preprocessing; black images pad."""
        cfg = self.cfg
        boxes, exists = [], []
        for i, cid in enumerate(ids):
            if cid == -1:
                exists += [0] * cfg.max_num_ip_sources
                boxes += [None] * cfg.max_num_ip_sources
                continue
            id_boxes = []
            if rng.random() < cfg.ip_self_condition_rate and i < len(page_bbox):
                x1, y1, x2, y2 = page_bbox[i]
                if (y2 - y1) > cfg.min_ip_height and (x2 - x1) > cfg.min_ip_width:
                    id_boxes = [page_bbox[i]]
            candidates = []
            for frame in ann["frames"]:
                for char in frame["characters"]:
                    x1, y1, x2, y2 = char["bbox"]
                    if (char["id"] == cid and (y2 - y1) > cfg.min_ip_height
                            and (x2 - x1) > cfg.min_ip_width and char.get("type", 0) == 0):
                        candidates.append(char["bbox"])
            take = min(cfg.max_num_ip_sources - len(id_boxes), len(candidates))
            id_boxes += rng.sample(candidates, take)
            exists += [1] * len(id_boxes)
            exists += [0] * (cfg.max_num_ip_sources - len(id_boxes))
            boxes += id_boxes + [None] * (cfg.max_num_ip_sources - len(id_boxes))

        clip_imgs, magi_imgs = [], []
        for flag, box in zip(exists, boxes):
            if flag:
                crop = geometry.maybe_flip(page_image.crop(tuple(box)),
                                           rng.random() < cfg.ip_flip_rate)
            else:
                crop = Image.new("RGB", (224, 224), (0, 0, 0))
            clip_imgs.append(processors.clip_preprocess(crop))
            magi_imgs.append(processors.vit_preprocess(crop))
        n, s = cfg.max_num_ips, cfg.max_num_ip_sources
        return (np.stack(clip_imgs).reshape(n, s, 224, 224, 3),
                np.stack(magi_imgs).reshape(n, s, 224, 224, 3),
                np.asarray(exists, np.float32).reshape(n, s))

    # -- sample build (reference :210-298) -------------------------------------
    def get_sample(self, bucket_key: Tuple[int, int], sample_idx: int,
                   rng: random.Random) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        bh, bw = bucket_key
        entry = self.buckets[bucket_key][sample_idx]
        ann = self.annotations[entry["ann_idx"]]
        frame_info = ann["frames"][entry["frame_idx"]]
        x1, y1, x2, y2 = frame_info["bbox"]

        if "image" in ann:          # tests hand PIL images in directly
            page_image = ann["image"].convert("RGB")
        else:
            page_image = Image.open(
                os.path.join(self.image_root, ann["image_path"])).convert("RGB")
        if cfg.mask_dialog:
            page_image = geometry.mask_dialogs_from_image(page_image, ann)
        panel, crop_tl = geometry.resize_and_center_crop(
            page_image.crop((x1, y1, x2, y2)), (bh, bw))

        caption = "" if rng.random() < cfg.t_drop_rate else frame_info.get("caption", "")
        ids_1 = np.asarray(self.tokenize(caption), np.int32).reshape(-1)
        ids_2 = np.asarray(self.tokenize_2(caption), np.int32).reshape(-1)

        char_ids, ip_bbox, page_bbox = self._sample_condition_characters(
            frame_info, self._support_ip_ids(ann), rng)
        clip_imgs, magi_imgs, ip_exists = self._load_ip_images(
            ann, char_ids, page_bbox, page_image, rng)

        # context image: a random other frame of the page, CLIP-preprocessed,
        # black with c_drop_rate or where the page has one frame
        context = None
        if cfg.load_context_image:
            frames = ann["frames"]
            if len(frames) > 1 and rng.random() >= cfg.c_drop_rate:
                others = frames[: entry["frame_idx"]] + frames[entry["frame_idx"] + 1:]
                context_img = page_image.crop(tuple(rng.choice(others)["bbox"]))
                drop_context = 0.0
            else:
                context_img = Image.new("RGB", (224, 224), (0, 0, 0))
                drop_context = 1.0
            context = (processors.clip_preprocess(context_img),
                       np.asarray(drop_context, np.float32))

        dialogs = frame_info.get("dialogs", [])
        dialog_bbox = []
        for idx in rng.sample(range(len(dialogs)), len(dialogs)):
            dialog_bbox.append(geometry.get_relative_bbox(frame_info["bbox"],
                                                          dialogs[idx]["bbox"]))
            if len(dialog_bbox) >= cfg.max_num_dialogs:
                break
        while len(dialog_bbox) < cfg.max_num_dialogs:
            dialog_bbox.append([0.0, 0.0, 0.0, 0.0])

        sample = {
            "pixel_values": processors.panel_transform(panel).astype(np.float32),
            "text_input_ids": ids_1,
            "text_input_ids_2": ids_2,
            "ip_pixel_values": clip_imgs,
            "magi_pixel_values": magi_imgs,
            "ip_exists": ip_exists,
            "ip_bbox": np.asarray(ip_bbox, np.float32),
            "dialog_bbox": np.asarray(dialog_bbox, np.float32),
            "original_size": np.asarray([y2 - y1, x2 - x1], np.float32),
            "crop_coords_top_left": np.asarray(crop_tl, np.float32),
            "target_size": np.asarray([bh, bw], np.float32),
        }
        if context is not None:
            sample["context_pixel_values"], sample["drop_context"] = context
        return sample

    # -- batching (reference BucketBatchSampler :488-544) ----------------------
    def bucket_batch_size(self, bucket_key) -> int:
        """The per-rank base size over 4^size_index, at least 1 (reference
        :503), times ``data_parallel``, so that every batch splits evenly."""
        idx = self.bucket_size_index[bucket_key]
        return max(1, round(self.cfg.batch_size / (2 ** (idx * 2)))) * self.cfg.data_parallel

    def num_batches(self) -> int:
        """Batches in one epoch (the same for every seed)."""
        return sum(-(-len(v) // self.bucket_batch_size(k)) for k, v in self.buckets.items())

    def batches(self, shuffle: bool = True, seed: Optional[int] = None,
                num_workers: int = 0, skip: int = 0, host_id: int = 0,
                num_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch of fixed-shape numpy batches with ``sample_mask``, from
        its ``skip``-th batch on (the skipped ones are not built: a resumed
        run takes up the stream where it stopped). ``num_workers > 0`` builds
        each batch's samples on a thread pool (PIL decode and resize release
        the GIL); the stream does not depend on it. Rank ``host_id`` of
        ``num_hosts`` gets rows ``[host_id::num_hosts]`` of every batch; every
        bucket's batch size must divide by ``num_hosts``."""
        if num_hosts > 1 and any(self.bucket_batch_size(k) % num_hosts
                                 for k in self.bucket_keys):
            raise ValueError(
                f"bucket batch sizes must be divisible by num_hosts={num_hosts} (got "
                f"{[self.bucket_batch_size(k) for k in self.bucket_keys]})")
        rng = random.Random(seed)
        seed_base = seed if seed is not None else rng.randrange(2 ** 31)

        def sample_rng(key: Tuple[int, int], idx: int) -> random.Random:
            # int-only arithmetic: stable across processes and PYTHONHASHSEED
            return random.Random(((seed_base * 1_000_003 + key[0]) * 8_191 + key[1])
                                 * 1_000_003 + idx)

        plan: List[Tuple[Tuple[int, int], List[int]]] = []
        for key in self.bucket_keys:
            order = list(range(len(self.buckets[key])))
            if shuffle:
                rng.shuffle(order)
            bs = self.bucket_batch_size(key)
            for i in range(0, len(order), bs):
                plan.append((key, order[i:i + bs]))
        if shuffle:
            rng.shuffle(plan)

        pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None
        try:
            for key, idxs in plan[skip:]:
                bs = self.bucket_batch_size(key)
                mask = np.zeros((bs,), np.float32)
                mask[: len(idxs)] = 1.0
                # partial batches repeat samples, masked out of the loss
                padded = idxs + [idxs[i % len(idxs)] for i in range(bs - len(idxs))]
                local = padded[host_id::num_hosts]
                build = lambda i: self.get_sample(key, i, sample_rng(key, i))
                samples = list(pool.map(build, local)) if pool else [build(i) for i in local]
                batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
                batch["sample_mask"] = mask[host_id::num_hosts]
                yield batch
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
