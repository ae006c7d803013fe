"""Each traffic file's seeded draw is reproducible, and every seed asks for
the same work in another order."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from benchmark import serve, train

HERE = Path(__file__).resolve().parents[1]
SERVE = [p.stem for p in sorted((HERE / "traffic").glob("*.json"))
         if json.loads(p.read_text())["kind"] == "serve"]


def _traffic(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _key(spec):
    return (spec["height"], spec["width"], len(spec["characters"]), len(spec["dialog_bbox"]),
            spec["seed"], spec["prompt_ids"]["ids"].tobytes(),
            tuple(np.asarray(c).tobytes() for c in spec["characters"]),
            tuple(map(tuple, spec["ip_bbox"])))


@pytest.mark.parametrize("name", SERVE)
def test_serve_draw_repeats(name):
    t = _traffic(name)
    seed = 2 ** 33 + 17
    assert [_key(serve.request_spec(t, seed, i)) for i in range(6)] == \
        [_key(serve.request_spec(t, seed, i)) for i in range(6)]
    assert _key(serve.request_spec(t, seed, 0)) != _key(serve.request_spec(t, seed + 1, 0))
    assert serve.checked(t, seed, 49408) == serve.checked(t, seed, 49408)


@pytest.mark.parametrize("name", SERVE)
def test_serve_every_seed_asks_the_same_work(name):
    t = _traffic(name)
    cycle = max(len(t["sizes"]), len(t["characters"]), len(t["dialogs"]))

    def work(seed):
        specs = [serve.request_spec(t, seed, i) for i in range(3 * cycle)]
        return Counter((s["height"], s["width"], len(s["characters"]) > 0) for s in specs), \
            sorted(len(s["characters"]) for s in specs)

    assert work(1) == work(2 ** 40 + 3)


@pytest.mark.parametrize("name", SERVE)
def test_serve_ids_end_in_one_eos_the_pooled_token(name):
    spec = serve.request_spec(_traffic(name), 5, 0)
    for key in ("ids", "ids_2", "neg_ids", "neg_ids_2"):
        ids = spec["prompt_ids"][key][0]
        assert ids[0] == 49406 and ids.argmax() == int(np.flatnonzero(ids == 49407)[0])


def test_pages_repeat(tmp_path):
    t = dict(_traffic("stage2_1024_b8"), pages=3, page_size=320, frame_size=256)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    train.write_pages(a, t, 99)
    train.write_pages(b, t, 99)
    assert (a / "annotations.json").read_text() == (b / "annotations.json").read_text()
    assert (a / "page_2.png").read_bytes() == (b / "page_2.png").read_bytes()
