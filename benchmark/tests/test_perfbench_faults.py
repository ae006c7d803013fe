"""Runs of each cell at tiny size on the CPU, the timed path sound and then
broken underneath: ``correct`` must hold for the first and fail for each
fault the cell can have, at the cell's own limits: a step that leaves its
state unchanged, half of the batch left out, and for serving a panel
altered where it is produced. (One card, so no exchange between chips can
be left out.)"""

import contextlib
import time

import pytest
import torch

from benchmark import run as R
from benchmark.tests import tiny


def _serve(traffic_name, seed, **over):
    cfg, traffic = tiny.serve_cell(traffic_name, **over)
    cell = {"name": f"serve_{traffic_name}", "chips": 1}
    ctx = R.Context(cell, cfg, traffic, seed, 0.1, 0, torch.device("cpu"), time.perf_counter())
    return R.execute(ctx, R.load_bench())


@contextlib.contextmanager
def _serve_fault(monkeypatch, kind):
    from diffsensei_tpu_torch.models import unet as unet_mod
    from diffsensei_tpu_torch.pipelines import pipeline as pipe_mod

    if kind == "state_unchanged":        # the sampler's step returns its input
        monkeypatch.setattr(pipe_mod, "scheduler_step", lambda state, out, i, sample: sample)
    elif kind == "half_batch":           # the UNet runs the uncond half, copied over the rest
        forward = unet_mod.UNetMangaModel.forward

        def half(self, sample, *args, **kwargs):
            out = forward(self, sample, *args, **kwargs)
            n = out.shape[0] // 2
            return torch.cat([out[:n], out[:n]])
        monkeypatch.setattr(unet_mod.UNetMangaModel, "forward", half)
    elif kind == "answer_altered":       # the panel changed where it is produced
        decode = pipe_mod._decode
        monkeypatch.setattr(pipe_mod, "_decode",
                            lambda *a, **k: torch.clamp(decode(*a, **k) + 0.02, 0.0, 1.0))
    yield


SERVE_FAULTS = ["state_unchanged", "half_batch", "answer_altered"]


@pytest.mark.parametrize("traffic_name, over", [
    ("candidates_1024x4", dict(num_samples=2)),
    ("page_b1", dict(sizes=[[256, 256], [1344, 768]])),
])
def test_serve_sound_run_is_correct(traffic_name, over):
    torch.set_num_threads(4)
    res = _serve(traffic_name, 2 ** 35 + 1, **over)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("fault", SERVE_FAULTS)
def test_serve_fault_is_caught(monkeypatch, fault):
    torch.set_num_threads(4)
    with _serve_fault(monkeypatch, fault):
        res = _serve("candidates_1024x4", 2 ** 35 + 2, num_samples=2)
    assert not res["correct"], res["check"]


def _train(seed, fault=None):
    cfg, traffic = tiny.train_cell()
    cell = {"name": "train_stage2_1024_b8", "chips": 1}
    ctx = R.Context(cell, cfg, traffic, seed, 0.1, 0, torch.device("cpu"), time.perf_counter(),
                    fault=fault)
    return R.execute(ctx, R.load_bench())


def test_train_sound_run_is_correct():
    torch.set_num_threads(4)
    res = _train(2 ** 36 + 1)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_fault_is_caught(monkeypatch, fault):
    from diffsensei_tpu_torch.train import diffusion

    torch.set_num_threads(4)
    if fault == "state_unchanged":       # the step leaves the trainables as they were
        monkeypatch.setattr(diffusion.TrainState, "apply_gradients",
                            lambda self: setattr(self, "step", self.step + 1))
    res = _train(2 ** 36 + 2, "half_batch" if fault == "half_batch" else None)
    assert not res["correct"], res["check"]
