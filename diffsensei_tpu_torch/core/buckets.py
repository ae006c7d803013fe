"""Copy of ``diffsensei_tpu/core/buckets.py``: the same tables, kept equal by
``tests/test_torch_port_ops.py`` (the JAX package's ``core`` imports jax).

Aspect-ratio size buckets for varied-resolution manga panels.

The reference ships three hand-written 33-row tables (base sizes 256/512/1024;
``src/datasets/utils.py:6-121``). The tables have exploitable structure: rows with
ratio > 1 are the transposed mirror of the ratio < 1 rows, and the 256/1024 classes
are the 512 class scaled by exactly 1/2 and 2 — so the only irreducible data is the
17 wide-or-square (h, w) pairs of the 512 class, kept below as compatibility
constants (checkpoint/dataset compatibility requires bit-identical bucket shapes).

Buckets are first-class in the TPU build: every (h, w) bucket is a distinct XLA
compilation key, so bounding the bucket set bounds recompilation.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

# (h, w) pairs with h/w <= 1 for the 512 class, widest first.
# Compatibility data matching src/datasets/utils.py:47-64.
_BASE_512 = (
    (256, 1024), (256, 992), (272, 960), (288, 928), (288, 896), (304, 864),
    (320, 832), (320, 800), (336, 768), (352, 736), (368, 704), (384, 672),
    (416, 640), (432, 608), (448, 576), (480, 544), (512, 512),
)


@functools.lru_cache(maxsize=None)
def make_bucket_table(size: int) -> Tuple[Tuple[int, int, float], ...]:
    """All 33 (height, width, h/w ratio) buckets for one base-size class."""
    scale = size / 512
    base = [(int(h * scale), int(w * scale)) for h, w in _BASE_512]
    mirrored = [(w, h) for (h, w) in reversed(base[:-1])]
    return tuple((h, w, h / w) for (h, w) in base + mirrored)


SIZE_CLASSES = (256, 512, 1024)

#: Same schema as the reference's ``size_buckets``: list of dicts with "size"
#: and "buckets" = [[h, w, ratio], ...].
SIZE_BUCKETS = [
    {"size": s, "buckets": [list(row) for row in make_bucket_table(s)]}
    for s in SIZE_CLASSES
]


def get_bucket_size(height: int, width: int, size_buckets=None) -> Tuple[int, int, int]:
    """Pick the (h, w) bucket nearest in area, then nearest in aspect ratio.

    Mirrors ``src/datasets/utils.py:191-206``. Returns (bucket_h, bucket_w,
    size_class_index).
    """
    if size_buckets is None:
        size_buckets = SIZE_BUCKETS
    image_size = height * width
    image_ratio = height / width

    sizes = [sb["size"] ** 2 for sb in size_buckets]
    size_diffs = [abs(image_size - s) for s in sizes]
    class_idx = size_diffs.index(min(size_diffs))

    buckets = size_buckets[class_idx]["buckets"]
    ratio_diffs = [abs(image_ratio - b[2]) for b in buckets]
    bucket_idx = ratio_diffs.index(min(ratio_diffs))

    h, w, _ = buckets[bucket_idx]
    return int(h), int(w), class_idx


def snap_to_bucket(height: int, width: int) -> Tuple[int, int]:
    """Quantize a free-form serving resolution onto the bucket grid.

    The reference lets the demo UI pick any multiple-of-8 H/W, which is
    XLA-hostile (every new shape is a recompile). Serving paths call this to land
    on one of the 99 bucketed shapes; callers that need the exact requested shape
    can still pass ``snap=False`` downstream and pay the compile.
    """
    h, w, _ = get_bucket_size(height, width)
    return h, w


def all_bucket_shapes() -> Sequence[Tuple[int, int]]:
    """Every distinct (h, w) in the bucket system (compilation-cache keyspace)."""
    shapes = []
    for sb in SIZE_BUCKETS:
        for h, w, _ in sb["buckets"]:
            shapes.append((int(h), int(w)))
    return tuple(dict.fromkeys(shapes))
