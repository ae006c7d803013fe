"""A serving cell whose stack carries the SEED-X agent, at tiny size on the
CPU: a sound run is correct, with ``agent_gap`` under the fp32 limit; each
planted fault of the agent's path reads over it; the agent's blockwise draw
is what the program holds; the SDXL draw is the one it was before the agent
had weights; the reference decoder's least cost is the arithmetic by hand."""

import contextlib
import dataclasses
import hashlib
import json
import time

import pytest
import torch

from benchmark import flops as F
from benchmark import program as P
from benchmark import run as R
from benchmark import weights as W
from benchmark.reference import agent as RA
from benchmark.tests import tiny


def _agent_run(seed):
    cfg, traffic = tiny.agent_cell()
    cell = {"name": "serve_agent_tiny", "chips": 1}
    ctx = R.Context(cell, cfg, traffic, seed, 0.1, 0, torch.device("cpu"), time.perf_counter())
    return R.execute(ctx, R.load_bench()), ctx


def test_agent_sound_run_is_correct():
    torch.set_num_threads(4)
    res, ctx = _agent_run(2 ** 35 + 11)
    assert res["correct"], res["check"]
    assert res["check"]["agent_gap"]["value"] < tiny.AGENT_LIMIT
    # every part was compared: the logits, the generated features, the blend
    assert all(0 < ctx.raw_check[f"agent_{k}"] < tiny.AGENT_LIMIT
               for k in ("logits", "feat", "blend"))


@contextlib.contextmanager
def _agent_fault(monkeypatch, kind):
    from diffsensei_tpu_torch.data import mllm_dataset
    from diffsensei_tpu_torch.models.mllm import llama, seed_x
    from diffsensei_tpu_torch.serve import api

    if kind == "ladder_shifted":          # the forcing table one row down
        ladder = mllm_dataset.MLLMTokenSpec.ladder_ids
        monkeypatch.setattr(mllm_dataset.MLLMTokenSpec, "ladder_ids",
                            property(lambda self: ladder.fget(self) - 1))
    elif kind == "cache_index_plus_one":  # every K/V written one slot late
        caches, forward = seed_x.init_caches, llama.LlamaForCausalLM.forward
        monkeypatch.setattr(seed_x, "init_caches",
                            lambda cfg, b, n, *a, **k: caches(cfg, b, n + 1, *a, **k))

        def late(self, *args, cache_index=None, **kwargs):
            return forward(self, *args, **kwargs,
                           cache_index=None if cache_index is None else cache_index + 1)
        monkeypatch.setattr(llama.LlamaForCausalLM, "forward", late)
    elif kind == "mllm_scale_ignored":    # the agent's features taken whole
        adapt = api.DiffSenseiServer._adapt_with_mllm
        monkeypatch.setattr(api.DiffSenseiServer, "_adapt_with_mllm",
                            lambda self, req, *a: adapt(self, dataclasses.replace(
                                req, mllm_scale=1.0), *a))
    yield


@pytest.mark.parametrize("fault", ["ladder_shifted", "cache_index_plus_one",
                                   "mllm_scale_ignored"])
def test_agent_fault_is_caught(monkeypatch, fault):
    torch.set_num_threads(4)
    with _agent_fault(monkeypatch, fault):
        res, _ = _agent_run(2 ** 35 + 12)
    assert not res["correct"]
    assert res["check"]["agent_gap"]["value"] > tiny.AGENT_LIMIT, res["check"]


def test_agent_draw_is_the_programs_weights():
    torch.set_num_threads(2)
    stack = tiny.agent_cell()[0]["stack"]
    seed = 2 ** 40 + 3
    lvlm = P.agent(stack, W.make_agent(stack, seed, "cpu"), torch.device("cpu"))
    held = {net: mod.state_dict() for net, mod in
            zip(("llm", "input_resampler", "output_resampler"), lvlm.networks())}
    blocks = W.agent_layout(stack)
    assert list(blocks) == ["llm.embed", "llm.layers.0", "llm.layers.1", "llm.head",
                            "input_resampler", "output_resampler"]
    names = 0
    for block, (net, params) in blocks.items():
        drawn = W.agent_block(stack, seed, block, "cpu")
        other = W.agent_block(stack, seed + 1, block, "cpu")
        for name, t in drawn.items():
            assert torch.equal(held[net][name], t), (block, name)
            assert not torch.equal(other[name], t), (block, name)
        names += len(params)
    assert names == sum(len(s) for s in held.values())
    # the new rule: the resamplers' packed attention bias is drawn as a bias
    bias = W.agent_block(stack, seed, "input_resampler", "cpu")["attn.in_proj_bias"]
    assert abs(bias.mean().item()) < 0.02 and bias.std().item() == pytest.approx(0.02, rel=0.25)


def test_sdxl_draw_is_pinned():
    """The SDXL draw of the tiny stack, agent or not, hashes as it did
    before the agent had weights of its own."""
    torch.set_num_threads(2)
    w = W.make(tiny.agent_cell()[0]["stack"], 2 ** 35 + 7, "cpu")
    h = hashlib.sha256()
    for net in sorted(w):
        for name in sorted(w[net]):
            h.update(net.encode())
            h.update(name.encode())
            h.update(w[net][name].contiguous().numpy().tobytes())
    assert h.hexdigest() == "d97832915d050e9a0ec1d57b21cca3bb00373d0dc57d123b7b09169f714a6ad7"


def test_llama_least_cost_by_hand():
    agent = tiny.agent_cell()[0]["stack"]["agent"]
    cfg = RA.llm_config(agent)      # V 512, D 64, F 128, 2 layers, 4 heads of 16, 2 KV heads
    got = RA.decoder(agent).least_cost(cfg, prompt_len=10, new_tokens=3, dtype_bytes=2)
    layer = 2 * 64 * 64 + 2 * 64 * 32 + 3 * 64 * 128 + 2 * 64      # q, o; k, v; MLP; norms
    weights = 2 * layer + 64 + 512 * 64                              # + final norm, head
    p = 10
    assert got["prefill_flops"] == 2 * (2 * p * (layer - 128) + 2 * 2 * 4 * p * p * 16) \
        + 2 * 64 * 512
    assert got["prefill_bytes"] == 2 * (weights + p * 64)
    kv_row = 2 * 2 * 2 * 16                  # K and V, 2 layers, 2 KV heads of 16
    assert got["decode_bytes"] == 2 * (3 * (weights + 64) + kv_row * (11 + 12 + 13))


def test_agent_least_time_is_a_term_of_its_own():
    stack = json.dumps(tiny.agent_cell()[0]["stack"], sort_keys=True)
    agent = tiny.AGENT
    one, two = F.agent_least_s(stack, 20, 10), F.agent_least_s(stack, 20, 11)
    step = RA.decoder(agent).least_cost(RA.llm_config(agent), 20, 11, 4)["decode_bytes"] \
        - RA.decoder(agent).least_cost(RA.llm_config(agent), 20, 10, 4)["decode_bytes"]
    assert two - one == pytest.approx(step / 3.35e12)
