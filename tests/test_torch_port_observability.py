"""The port's spans (``utils/observability.py``'s ``span``) and its step
timer: the no-op without a profiler, the profiler's clock, the span tree of
one served request and one train step, the loader's threads;
and ``StepTimer``'s means over a log interval. Torch only."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffsensei_tpu_torch.data.loader import PrefetchLoader
from diffsensei_tpu_torch.models import unet as unet_mod
from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline, PipelineModules
from diffsensei_tpu_torch.serve.api import DiffSenseiServer, GenerationRequest
from diffsensei_tpu_torch.train import diffusion as tdiff
from diffsensei_tpu_torch.train import optim as toptim
from diffsensei_tpu_torch.utils import observability as obs
from diffsensei_tpu_torch.utils.observability import SPANS, StepTimer, span


def _recorded(fn):
    """``fn()`` under a CPU profiler: (its spans as ``SpanRecord``s, the
    profiler's events)."""
    SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    got = list(SPANS)
    SPANS.clear()
    return got, prof.events()


def _named(records, name):
    return [r for r in records if r.name == name]


def _children(records, parent, name):
    return [r for r in records if r.parent == parent.id and r.name == name]


# ---------------------------------------------------------------------------
# the primitive
# ---------------------------------------------------------------------------
def test_span_off_is_the_shared_noop_and_records_nothing():
    SPANS.clear()
    first = span("x.off", i=1)
    assert first is span("y.off") is obs._NOOP
    with span("x.off", i=1):
        torch.ones(4).sum()
    assert not SPANS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert not [e for e in prof.events() if e.name == "x.off"]
    assert not SPANS


def test_span_on_shares_the_profilers_clock():
    """Under the profiler a span is a user annotation whose range holds the
    op launched inside it, on the same thread; its record nests by thread."""
    a, b = torch.ones(16, 16), torch.ones(16, 16)

    def body():
        with span("outer.s", request=7):
            with span("inner.s"):
                torch.mm(a, b)

    records, events = _recorded(body)
    (ann,) = [e for e in events if e.name == "inner.s"]
    assert ann.is_user_annotation
    (mm,) = [e for e in events if e.name == "aten::mm"]
    assert ann.thread == mm.thread
    assert ann.time_range.start <= mm.time_range.start <= mm.time_range.end <= ann.time_range.end
    (outer,) = _named(records, "outer.s")
    (inner,) = _named(records, "inner.s")
    assert outer.parent is None and inner.parent == outer.id
    assert outer.attrs == inner.attrs == {"request": 7}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.thread == inner.thread == threading.get_ident()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _ids():
    rng = np.random.default_rng(0)
    return {k: rng.integers(1, 255, (1, 77)) for k in ("ids", "neg_ids", "ids_2", "neg_ids_2")}


def _picture(w, h):
    from PIL import Image

    rng = np.random.default_rng(w * h)
    return Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8))


@pytest.fixture(scope="module")
def server():
    return DiffSenseiServer(DiffSenseiPipeline(PipelineModules.tiny(device="cpu")))


def test_a_served_request_gives_its_span_tree(server):
    chars = [_picture(40, 60), _picture(50, 30)]
    req = GenerationRequest(height=128, width=128, num_inference_steps=2, prompt_ids=_ids(),
                            character_images=chars, ip_bbox=[[0, 0, .5, 1], [.5, 0, 1, 1]],
                            dialog_bbox=[[.1, 0, .5, .2]])
    server.generate(req)      # a request before the profiler: numbered, not recorded
    records, events = _recorded(lambda: server.generate(req))
    names = ("serve.request", "serve.prepare", "pipeline.conditioning", "pipeline.decode",
             "serve.readback")
    for name in names:
        assert len(_named(records, name)) == 1, name
    (root,) = _named(records, "serve.request")
    assert root.parent is None
    request = {"request": 1, "num_samples": 1, "height": 128, "width": 128}
    assert root.attrs == request
    for name in ("serve.prepare", "pipeline.conditioning", "pipeline.decode", "serve.readback"):
        assert _named(records, name)[0].parent == root.id, name
    (cond,) = _named(records, "pipeline.conditioning")
    for name in ("pipeline.encode_prompt", "pipeline.ip_embeds", "pipeline.ip_bias"):
        assert len(_children(records, cond, name)) == 1, name
    steps = _named(records, "denoise.step")
    assert [s.attrs["i"] for s in steps] == [0, 1]
    for s in steps:
        assert s.parent == root.id
        assert len(_children(records, s, "denoise.unet")) == 1
        assert len(_children(records, s, "denoise.sampler")) == 1
    assert _named(records, "pipeline.decode")[0].attrs == dict(request, tiled=False, tiles=1)
    assert [u.attrs["i"] for s in steps for u in _children(records, s, "denoise.unet")] == [0, 1]

    # every span belongs to the request: its number, inside its range, on its thread
    for r in records:
        assert r.attrs["request"] == 1
        assert r.thread == root.thread
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
    # and the profiler saw the same spans as annotations
    annotated = [e.name for e in events if e.is_user_annotation and "." in e.name
                 and e.name.split(".")[0] in ("serve", "pipeline", "denoise")]
    assert sorted(annotated) == sorted(r.name for r in records)


def test_requests_are_numbered_by_the_server(server):
    req = GenerationRequest(height=128, width=128, num_inference_steps=1, prompt_ids=_ids())
    first = server.requests
    records, _ = _recorded(lambda: [server.generate(req) for _ in range(2)])
    roots = _named(records, "serve.request")
    assert [r.attrs["request"] for r in roots] == [first, first + 1]
    for r in records:
        owner = r
        while owner.parent is not None:
            (owner,) = [x for x in records if x.id == owner.parent]
        assert owner in roots and r.attrs["request"] == owner.attrs["request"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _stage2_batch(manga, b=1, hw=32, sources=1):
    rng = np.random.default_rng(3)
    i = manga.max_num_ips
    arrays = {
        "pixel_values": rng.uniform(-1, 1, (b, hw, hw, 3)),
        "text_input_ids": rng.integers(1, 250, (b, 77)),
        "text_input_ids_2": rng.integers(1, 250, (b, 77)),
        "ip_pixel_values": rng.uniform(0, 1, (b, i, sources, 224, 224, 3)),
        "magi_pixel_values": rng.uniform(0, 1, (b, i, sources, 224, 224, 3)),
        "ip_exists": np.ones((b, i, sources)),
        "ip_bbox": rng.uniform(0, 1, (b, i, 4)),
        "dialog_bbox": rng.uniform(0, 1, (b, manga.max_num_dialogs, 4)),
        "original_size": np.full((b, 2), float(hw)),
        "crop_coords_top_left": np.zeros((b, 2)),
        "target_size": np.full((b, 2), float(hw)),
    }
    return {k: torch.from_numpy(v).float() if v.dtype.kind == "f" else torch.from_numpy(v)
            for k, v in arrays.items()}


@pytest.fixture(scope="module")
def trainer():
    mods = PipelineModules.tiny(device="cpu")
    unet = mods.unet
    trainable, _ = toptim.partition_params(unet, toptim.unet_trainable_mask(unet, "new"))
    params = {f"unet.{k}": p for k, p in trainable.items()}
    trainable, _ = toptim.partition_params(
        mods.resampler, {k: True for k, _ in mods.resampler.named_parameters()})
    params.update({f"resampler.{k}": p for k, p in trainable.items()})
    state = tdiff.TrainState(params, toptim.make_optimizer(params.values(), 1e-4))
    frozen = tdiff.FrozenDiffusionStack(
        vae=mods.vae, text_encoder=mods.text_encoder, text_encoder_2=mods.text_encoder_2,
        image_encoder=mods.image_encoder, magi_encoder=mods.magi_encoder,
        vae_scaling=mods.vae.config.scaling_factor)
    step = tdiff.make_stage2_step(unet, mods.resampler, DDPMSchedule(),
                                  tdiff.Stage2Config(manga=mods.manga, ip_contrastive="fast"))
    return unet, step, state, frozen, _stage2_batch(mods.manga)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_a_train_step_gives_its_span_tree(trainer, monkeypatch, remat):
    unet, step, state, frozen, batch = trainer
    blocks = []
    inner = unet_mod.checkpoint

    def counted(*args, **kwargs):
        blocks.append(args[0])
        return inner(*args, **kwargs)

    monkeypatch.setattr(unet_mod, "checkpoint", counted)
    unet.remat = remat
    try:
        records, _ = _recorded(lambda: step(state, frozen, batch, torch.Generator().manual_seed(0)))
    finally:
        unet.remat = False
    (root,) = _named(records, "train.step")
    assert root.parent is None and root.attrs == {"step": state.step - 1}
    assert all(r.attrs == root.attrs for r in records)
    for name in ("train.forward", "train.backward", "train.optimizer", "train.metrics"):
        assert len(_children(records, root, name)) == 1, name
    (fwd,) = _named(records, "train.forward")
    (enc,) = _children(records, fwd, "train.encode")
    assert len(_children(records, enc, "train.vae_encode")) == 1
    assert len(_children(records, fwd, "train.unet_forward")) == 1
    (bwd,) = _named(records, "train.backward")
    replays = _named(records, "train.remat_replay")
    if remat:
        assert len(blocks) > 0 and len(replays) == len(blocks)
        assert all(r.parent == bwd.id for r in replays)
    else:
        assert not blocks and not replays


def test_the_loaders_spans_name_their_threads():
    """``data.put`` on the producer's thread, ``data.wait`` on the consumer's."""
    def factory(epoch):
        for k in range(3):
            yield {"x": np.full((2, 2), k, np.float32)}

    def consume():
        got = [b["x"][0, 0].item() for b in PrefetchLoader(factory, device="cpu", num_epochs=1)]
        assert got == [0.0, 1.0, 2.0]

    records, _ = _recorded(consume)
    puts, waits = _named(records, "data.put"), _named(records, "data.wait")
    assert len(puts) == 3 and len(waits) >= 3
    assert {r.thread for r in waits} == {threading.get_ident()}
    assert threading.get_ident() not in {r.thread for r in puts}
    assert len({r.thread for r in puts}) == 1


# ---------------------------------------------------------------------------
# StepTimer
# ---------------------------------------------------------------------------
def test_step_timer_means_over_the_log_interval():
    # sleeps overshoot on a loaded machine: lower bounds only
    t = StepTimer()
    for _ in range(2):
        time.sleep(0.04)
        t.data_ready()
        time.sleep(0.02)
        t.step_done()
    s = t.scalars()
    assert s["time/data_s"] >= 0.035 and s["time/step_s"] >= 0.015
    # the next interval starts at the logged point: one step of it
    time.sleep(0.01)
    t.data_ready()
    time.sleep(0.05)
    t.step_done()
    s = t.scalars()
    assert s["time/data_s"] >= 0.008 and s["time/step_s"] >= 0.045
