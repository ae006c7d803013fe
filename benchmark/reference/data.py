"""The plain reference of the stage-2 batches: MangaZero pages to the batch a
train step reads (DiffSensei's ``dataset_size_bucket.py``: size buckets,
per-class batch sizes, character sampling with self-condition and flips,
CLIP and ViT preprocessing, caption dropout, dialog boxes).

Single-threaded, numpy and PIL. The draws of a sample come from
``Random(epoch seed, bucket, index)`` and the epoch plan from ``Random(epoch
seed)``, so the batches depend on the seed alone. Captions become ids by
CRC-32 word hashing (bos, a word an id, eos, zeros), the stand-in tokenizer of
runs without vocabulary files.
"""

from __future__ import annotations

import json
import os
import random
import zlib
from typing import Dict, Iterator, List, Tuple

import numpy as np
from PIL import Image, ImageOps

from benchmark.reference.diffusion import clip_pixels

BASE_512 = ((256, 1024), (256, 992), (272, 960), (288, 928), (288, 896), (304, 864),
            (320, 832), (320, 800), (336, 768), (352, 736), (368, 704), (384, 672),
            (416, 640), (432, 608), (448, 576), (480, 544), (512, 512))
SIZE_CLASSES = (256, 512, 1024)


def bucket_table(size: int):
    scale = size / 512
    base = [(int(h * scale), int(w * scale)) for h, w in BASE_512]
    return [(h, w, h / w) for h, w in base + [(w, h) for h, w in reversed(base[:-1])]]


def bucket_of(h: float, w: float) -> Tuple[int, int, int]:
    """Nearest class by area, then nearest ratio: (bucket h, bucket w, class)."""
    diffs = [abs(h * w - s * s) for s in SIZE_CLASSES]
    cls = diffs.index(min(diffs))
    table = bucket_table(SIZE_CLASSES[cls])
    ratios = [abs(h / w - r) for _, _, r in table]
    bh, bw, _ = table[ratios.index(min(ratios))]
    return int(bh), int(bw), cls


def hash_ids(text: str, vocab: int = 49408, length: int = 77) -> np.ndarray:
    words = text.split()[: length - 2]
    ids = np.zeros((length,), np.int32)
    ids[0] = vocab - 2
    for i, word in enumerate(words):
        ids[i + 1] = zlib.crc32(word.encode()) % (vocab - 3) + 1
    ids[len(words) + 1] = vocab - 1
    return ids


def relative(bg, fg):
    bx1, by1, bx2, by2 = bg
    fx1, fy1, fx2, fy2 = fg
    w, h = bx2 - bx1, by2 - by1
    return [(fx1 - bx1) / w, (fy1 - by1) / h, (fx2 - bx1) / w, (fy2 - by1) / h]


def vit_pixels(image, size: int = 224) -> np.ndarray:
    if image.size[0] == 0 or image.size[1] == 0:
        return np.zeros((size, size, 3), np.float32)
    arr = np.asarray(image.resize((size, size), Image.BICUBIC).convert("RGB"), np.float32) / 255.0
    return (arr - 0.5) / 0.5


def fit_bucket(image, hb, wb):
    wa, ha = image.size
    if ha / wa >= hb / wb:
        nh, nw = int(ha * wb / wa), wb
    else:
        nh, nw = hb, int(wa * hb / ha)
    resized = image.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - wb) // 2, (nh - hb) // 2
    return resized.crop((left, top, left + wb, top + hb)), (top, left)


class Pages:
    """The page set's frames in buckets, and its epochs of batches."""

    def __init__(self, ann_path: str, image_root: str, data: Dict, manga: Dict,
                 vocab: int = 49408, vocab_2: int = 49408):
        with open(ann_path) as f:
            self.anns = json.load(f)
        self.root, self.d, self.manga = image_root, data, manga
        self.vocab, self.vocab_2 = vocab, vocab_2
        self.buckets: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        self.cls: Dict[Tuple[int, int], int] = {}
        for a, ann in enumerate(self.anns):
            for fi, frame in enumerate(ann["frames"]):
                x1, y1, x2, y2 = frame["bbox"]
                bh, bw, c = bucket_of(y2 - y1, x2 - x1)
                self.buckets.setdefault((bh, bw), []).append((a, fi))
                self.cls[(bh, bw)] = c

    def batch_size(self, key) -> int:
        return max(1, round(self.d["batch_size"] / (2 ** (self.cls[key] * 2))))

    def sample(self, key, idx, rng: random.Random) -> Dict[str, np.ndarray]:
        d, manga = self.d, self.manga
        ni, ns = manga["max_num_ips"], d["max_num_ip_sources"]
        a, fi = self.buckets[key][idx]
        ann = self.anns[a]
        frame = ann["frames"][fi]
        page = Image.open(os.path.join(self.root, ann["image_path"])).convert("RGB")
        panel, crop_tl = fit_bucket(page.crop(tuple(frame["bbox"])), *key)
        caption = "" if rng.random() < d["t_drop_rate"] else frame.get("caption", "")
        # characters: ids seen twice in one frame are ambiguous and left out
        ambiguous = set()
        for fr in ann["frames"]:
            seen: Dict[int, int] = {}
            for c in fr["characters"]:
                seen[c["id"]] = seen.get(c["id"], 0) + 1
            ambiguous.update(k for k, n in seen.items() if n > 1)
        ids, bbox, page_bbox = [], [], []
        chars = frame["characters"]
        for j in rng.sample(range(len(chars)), len(chars)):
            c = chars[j]
            if c["id"] in ambiguous or rng.random() < d["i_drop_rate"]:
                continue
            ids.append(c["id"])
            bbox.append(relative(frame["bbox"], c["bbox"]))
            page_bbox.append(c["bbox"])
            if len(ids) >= ni:
                break
        while len(ids) < ni:
            ids.append(-1)
            bbox.append([0.0, 0.0, 0.0, 0.0])
        boxes, exists = [], []
        for k, cid in enumerate(ids):
            if cid == -1:
                exists += [0] * ns
                boxes += [None] * ns
                continue
            own = []
            if rng.random() < d["ip_self_condition_rate"] and k < len(page_bbox):
                x1, y1, x2, y2 = page_bbox[k]
                if (y2 - y1) > 5 and (x2 - x1) > 5:
                    own = [page_bbox[k]]
            cands = [c["bbox"] for fr in ann["frames"] for c in fr["characters"]
                     if c["id"] == cid and (c["bbox"][3] - c["bbox"][1]) > 5
                     and (c["bbox"][2] - c["bbox"][0]) > 5 and c.get("type", 0) == 0]
            own += rng.sample(cands, min(ns - len(own), len(cands)))
            exists += [1] * len(own) + [0] * (ns - len(own))
            boxes += own + [None] * (ns - len(own))
        clip, magi = [], []
        for flag, box in zip(exists, boxes):
            if flag:
                crop = page.crop(tuple(box))
                if rng.random() < d["ip_flip_rate"]:
                    crop = ImageOps.mirror(crop)
            else:
                crop = Image.new("RGB", (224, 224), (0, 0, 0))
            clip.append(clip_pixels(crop))
            magi.append(vit_pixels(crop))
        dialogs = frame.get("dialogs", [])
        dialog_bbox = []
        for j in rng.sample(range(len(dialogs)), len(dialogs)):
            dialog_bbox.append(relative(frame["bbox"], dialogs[j]["bbox"]))
            if len(dialog_bbox) >= manga["max_num_dialogs"]:
                break
        while len(dialog_bbox) < manga["max_num_dialogs"]:
            dialog_bbox.append([0.0, 0.0, 0.0, 0.0])
        x1, y1, x2, y2 = frame["bbox"]
        return {
            "pixel_values": (np.asarray(panel.convert("RGB"), np.float32) / 255.0 * 2.0 - 1.0),
            "text_input_ids": hash_ids(caption, self.vocab),
            "text_input_ids_2": hash_ids(caption, self.vocab_2),
            "ip_pixel_values": np.stack(clip).reshape(ni, ns, 224, 224, 3),
            "magi_pixel_values": np.stack(magi).reshape(ni, ns, 224, 224, 3),
            "ip_exists": np.asarray(exists, np.float32).reshape(ni, ns),
            "ip_bbox": np.asarray(bbox, np.float32),
            "dialog_bbox": np.asarray(dialog_bbox, np.float32),
            "original_size": np.asarray([y2 - y1, x2 - x1], np.float32),
            "crop_coords_top_left": np.asarray(crop_tl, np.float32),
            "target_size": np.asarray(key, np.float32),
        }

    def epoch(self, seed: int) -> Iterator[Dict[str, np.ndarray]]:
        """One shuffled epoch of batches, partial ones padded and masked."""
        rng = random.Random(seed)
        plan = []
        for key, items in self.buckets.items():
            order = list(range(len(items)))
            rng.shuffle(order)
            bs = self.batch_size(key)
            plan += [(key, order[i:i + bs]) for i in range(0, len(order), bs)]
        rng.shuffle(plan)
        for key, idxs in plan:
            bs = self.batch_size(key)
            mask = np.zeros((bs,), np.float32)
            mask[:len(idxs)] = 1.0
            padded = idxs + [idxs[i % len(idxs)] for i in range(bs - len(idxs))]
            samples = [self.sample(key, i, random.Random(
                ((seed * 1_000_003 + key[0]) * 8_191 + key[1]) * 1_000_003 + i)) for i in padded]
            batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            batch["sample_mask"] = mask
            yield batch
