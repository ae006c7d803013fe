"""The port's eval and inference datasets, page geometry helpers, demo
examples and the gradio demo's pure helpers against the JAX package's (CPU).

Both packages read the same seeded synthetic MangaZero pages with
``random.Random`` generators of one seed, so every item must be the same
bytes: captions, sizes, boxes, the PIL crops, the prompt ids and masks.
"""

import copy
import json
import random

import numpy as np
import pytest
from PIL import Image

from diffsensei_tpu.data import eval_dataset as jeval, geometry as jgeo
from diffsensei_tpu.data import mllm_dataset as jmllm
from diffsensei_tpu.serve import examples as jexamples, gradio_demo as jgradio

from diffsensei_tpu_torch.data import eval_dataset as teval, geometry as tgeo
from diffsensei_tpu_torch.data import mllm_dataset as tmllm
from diffsensei_tpu_torch.serve import examples as texamples, gradio_demo as tgradio

from tests.torch_port_util import mangazero_pages


def _spec(module):
    ladder = list(range(480, 512))
    return module.MLLMTokenSpec(
        bos_id=1, eos_id=2, pad_id=0, boi_id=ladder[0], eoi_id=ladder[-1],
        img_ids=ladder[1:-1], encode_text=lambda s: [(ord(c) % 40) + 3 for c in s if c != " "])


def _pages(tmp_path=None):
    """Four seeded pages; with ``tmp_path`` written as files (images and
    ``annotations.json``), else with their images inline."""
    anns = mangazero_pages(np.random.default_rng(21), n_pages=3)
    anns.append(copy.deepcopy(anns[2]))
    anns[3]["image_path"] = "page_3.png"
    anns[3]["frames"][1]["characters"][1]["bbox"] = [45, 30, 140, 200]   # a second source
    if tmp_path is not None:
        for ann in anns:
            ann.pop("image").save(tmp_path / ann["image_path"])
        (tmp_path / "annotations.json").write_text(json.dumps(anns))
    return anns


def _same_items(got_ds, want_ds, passes=2):
    """Every item of both datasets, read ``passes`` times in order."""
    assert len(got_ds) == len(want_ds) > 0
    for _ in range(passes):
        for idx in range(len(want_ds)):
            got, want = got_ds[idx], want_ds[idx]
            assert sorted(got) == sorted(want)
            for key, w in want.items():
                g = got[key]
                if key == "ip_images":
                    assert [(im.size, im.tobytes()) for im in g] == \
                           [(im.size, im.tobytes()) for im in w], idx
                elif isinstance(w, np.ndarray):
                    assert g.dtype == w.dtype and np.array_equal(g, w), (idx, key)
                elif key != "ann":
                    assert g == w, (idx, key)


@pytest.mark.parametrize("kw", [
    dict(), dict(snap=False, mask_dialog=True), dict(min_ip_height=112, max_num_ips=1),
    dict(max_num_dialogs=1, seed=5)])
@pytest.mark.parametrize("kind", ["eval", "eval_mllm", "inference_mllm"])
def test_page_datasets_give_the_jax_items(tmp_path, kind, kw):
    kw = dict(kw)
    seed = kw.pop("seed", 0)
    anns = _pages(tmp_path if kind == "inference_mllm" else None)
    names = dict(eval="MangaEvaluationDataset", eval_mllm="MangaEvalMLLMDataset",
                 inference_mllm="MangaInferenceMLLMDataset")
    made = []
    for module, mllm in ((teval, tmllm), (jeval, jmllm)):
        extra = {} if kind == "eval" else dict(mllm_spec=_spec(mllm))
        if kind == "inference_mllm":
            extra["max_caption_length"] = 5
            args = dict(ann_path=str(tmp_path / "annotations.json"), image_root=str(tmp_path))
        else:
            args = dict(ann_path=None, image_root="", annotations=copy.deepcopy(anns))
        made.append(getattr(module, names[kind])(rng=random.Random(seed), **args, **kw,
                                                 **extra))
    _same_items(*made)


@pytest.mark.parametrize("with_spec", [False, True])
def test_char_image_dataset_gives_the_jax_items(tmp_path, with_spec):
    rng = np.random.default_rng(22)
    for n in range(3):
        Image.fromarray(rng.integers(0, 255, (40 + 10 * n, 30, 3), np.uint8)).save(
            tmp_path / f"char_{n}.png")
    prompts = [dict(caption="two girls talk in the rain", character_images=[
                    "char_0.png", "char_1.png", "char_2.png"], ip_bbox=[[0, 0, .5, 1]],
                    dialog_bbox=[], height=1024, width=768),
               dict(caption="", character_images=["char_2.png"], height=512, width=512)]
    made = [module.MangaInferenceCharImageDataset(
        prompts, str(tmp_path), max_num_ips=2, max_caption_length=6,
        mllm_spec=_spec(mllm) if with_spec else None)
        for module, mllm in ((teval, tmllm), (jeval, jmllm))]
    _same_items(*made, passes=1)


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(23)
    for h, w in ((300, 500), (640, 200), (256, 256)):
        img = Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8))
        for got, want in ((tgeo.resize_and_pad(img, 512), jgeo.resize_and_pad(img, 512)),
                          (tgeo.center_crop_and_resize(jgeo.resize_and_pad(img, 512), w, h),
                           jgeo.center_crop_and_resize(jgeo.resize_and_pad(img, 512), w, h))):
            assert got.size == want.size and got.tobytes() == want.tobytes()
        xs, ys = np.sort(rng.uniform(-0.2, 1.2, (2, 4, 2)), axis=-1)
        boxes = np.stack([xs[:, 0], ys[:, 0], xs[:, 1], ys[:, 1]], axis=-1).tolist()
        got = tgeo.get_cropped_ip_images_from_relative_bbox(img, boxes)
        want = jgeo.get_cropped_ip_images_from_relative_bbox(img, boxes)
        assert [(c.size, c.tobytes()) for c in got] == [(c.size, c.tobytes()) for c in want]
    frame = {"bbox": [120, 40, 520, 440]}
    for box in ([10, 20, 110, 220], [0.5, 1.5, 33.25, 7]):
        assert tgeo.get_page_bbox(box, frame) == jgeo.get_page_bbox(box, frame)
    for rel in ([0.1, 0.2, 0.55, 0.9], [0.0, 0.0, 1.0, 1.0], [0.125, 0.375, 0.625, 0.875]):
        got = tgeo.get_page_bbox_from_rel_bbox(rel, frame["bbox"])
        assert got == jgeo.get_page_bbox_from_rel_bbox(rel, frame["bbox"])
        assert all(isinstance(v, int) for v in got)
    page = {"frames": [{"bbox": [x, y, x + 100, y + 80], "id": n} for n, (x, y) in enumerate(
        [(900, 10), (500, 40), (100, 30), (700, 260), (80, 300), (420, 520), (30, 530)])]}
    for width, threshold in ((1000, 100), (1000, 40), (600, 100)):
        assert tgeo.sort_manga_panels(page, width, threshold) == \
               jgeo.sort_manga_panels(page, width, threshold)


def test_demo_examples_are_the_jax_ones():
    assert texamples.example_inputs == jexamples.example_inputs
    assert texamples.example_inputs_wo_mllm == jexamples.example_inputs_wo_mllm


def test_gradio_helpers_match_jax():
    for text in ("", "0.1,0.2,0.5,0.9\n0.8 0.7 0.2 0.1\n\n1,2,3\n0,0,1,1,1",
                 "  0.25, 0.5 ,0.75,1.0  "):
        assert tgradio.parse_bbox_text(text) == jgradio.parse_bbox_text(text)
    points = [[10, 20, 2, 110, 60, 3], [300, 200, 2, 100, 40, 3], [1, 2, 3]]
    for pts in (points, [], None):
        assert tgradio.normalize_points_to_bboxes(pts, 400, 300) == \
               jgradio.normalize_points_to_bboxes(pts, 400, 300)
    canvases = [None, {}, {"image": None, "points": points},
                {"image": Image.new("RGB", (400, 300)), "points": points},
                {"image": np.zeros((300, 400, 3), np.uint8), "points": points},
                {"image": Image.new("RGB", (400, 300)), "points": []}]
    for canvas in canvases:
        assert tgradio.canvas_to_bboxes(canvas) == jgradio.canvas_to_bboxes(canvas)
    got, want = tgradio.blank_canvas(96, 128), jgradio.blank_canvas(96, 128)
    assert got["points"] == want["points"] == []
    assert got["image"].size == want["image"].size == (128, 96)
    assert got["image"].tobytes() == want["image"].tobytes()


def test_gradio_demo_imports_gradio_only_when_built():
    """The module imports without gradio; ``build_demo`` needs it."""
    import importlib.util

    if importlib.util.find_spec("gradio") is None:
        with pytest.raises(ImportError, match="gradio is not installed"):
            tgradio.build_demo(server=None)
    else:
        from types import SimpleNamespace
        from diffsensei_tpu_torch.core.config import PipelineConfig

        server = SimpleNamespace(agent=None, pipeline=SimpleNamespace(config=PipelineConfig()))
        assert tgradio.build_demo(server) is not None
