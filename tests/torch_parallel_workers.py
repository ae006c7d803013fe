"""Ranks of the multi-process tests of ``tests/test_torch_port_parallel.py``
and ``tests/test_torch_port_tensor_parallel.py``.

Run as ``python -m tests.torch_parallel_workers TASK DIR RANK WORLD``: the
rank joins a gloo group through a ``file://`` store in DIR, reads DIR/in.pt,
runs TASK on the CPU with one thread and writes DIR/out_RANK.pt. This module
imports torch and the port only (never jax): the test process builds the JAX
references and hands the port's weights over as state dicts. ``run_ranks``
starts the ranks and collects their results.
"""

import os
import subprocess
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(task: str, tmp, world: int, inputs: dict, timeout: float = 600) -> list:
    """Run ``task`` on ``world`` ranks with ``inputs``; their outputs by rank."""
    tmp = os.fspath(tmp)
    torch.save(inputs, os.path.join(tmp, "in.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_workers", task, tmp,
                               str(r), str(world)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {task} failed ({p.returncode}):\n{log[-4000:]}")
    return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# tasks: (inputs, rank, world) -> outputs
# ---------------------------------------------------------------------------
def _tiny_modules(state):
    from diffsensei_tpu_torch.pipelines.pipeline import PipelineModules

    mods = PipelineModules.tiny(device="cpu")
    for name, sd in state.items():
        getattr(mods, name).load_state_dict(sd)
    return mods


def task_ring(inp, rank, world):
    """The ring over the whole group and the dispatcher with ``cp_group``."""
    from diffsensei_tpu_torch.ops.attention import multi_head_attention
    from diffsensei_tpu_torch.ops.ring_attention import ring_attention_sharded

    out = {}
    for key, (q, k, v) in inp["qkv"].items():
        out[key] = ring_attention_sharded(q, k, v, dist.group.WORLD)
    q, k, v = inp["dispatch"]
    out["dispatch"] = multi_head_attention(q, k, v, cp_group=dist.group.WORLD)
    # a sequence the group does not divide takes the plain path
    q, k, v = inp["ragged"]
    out["ragged"] = multi_head_attention(q, k, v, cp_group=dist.group.WORLD)
    return out


def task_serve(inp, rank, world):
    """The tiny UNet with ``cp_min_seq``, the context-parallel pipeline and
    the batch-sharded pipeline (as in-process calls over a device mesh)."""
    from diffsensei_tpu_torch.core.config import PipelineConfig
    from diffsensei_tpu_torch.parallel.mesh import make_mesh
    from diffsensei_tpu_torch.pipelines.pipeline import DiffSenseiPipeline

    mods = _tiny_modules(inp["state"])
    out = {}
    with torch.no_grad():
        args, kwargs = inp["unet_args"]
        mods.unet.set_context_parallel(dist.group.WORLD, 8)
        out["unet_cp"] = mods.unet(*args, **kwargs)
        mods.unet.set_context_parallel(None)
    mesh = make_mesh(device="cpu")
    cp = DiffSenseiPipeline(mods, PipelineConfig(context_parallel=True,
                                                 context_parallel_min_seq=8), mesh=mesh)
    out["pipeline_cp"] = cp(**inp["cp_call"])
    out["unet_cp_after"] = mods.unet.cp_group is None
    batched = DiffSenseiPipeline(mods, mesh=mesh)
    out["pipeline_batched"] = batched(**inp["batched_call"])
    return out


def task_train_step(inp, rank, world):
    """A stage-2 step on this rank's rows under DDP, then under FSDP (fresh
    modules), two SGD-with-momentum updates each: losses (the ranks' mean),
    the synced gradients and the parameters, whole."""
    import copy

    from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
    from diffsensei_tpu_torch.parallel.mesh import host_rows, init_distributed
    from diffsensei_tpu_torch.parallel.train import (
        full_state, fsdp_train, reduce_metrics, wrap_ddp)
    from diffsensei_tpu_torch.train import diffusion, optim

    env = init_distributed("cpu")
    mods = _tiny_modules(inp["state"])
    batch = {k: host_rows(v, rank, world) for k, v in inp["batch"].items()}
    out = {}
    for mode in ("dp", "fsdp"):
        unet, resampler = copy.deepcopy(mods.unet), copy.deepcopy(mods.resampler)
        frozen = diffusion.FrozenDiffusionStack(
            **{n: copy.deepcopy(getattr(mods, n)) for n in (
                "vae", "text_encoder", "text_encoder_2", "image_encoder", "magi_encoder")},
            vae_scaling=mods.vae.config.scaling_factor)
        trainable, _ = optim.partition_params(unet, optim.unet_trainable_mask(unet, "new"))
        params = {f"unet.{k}": p for k, p in trainable.items()}
        trainable, _ = optim.partition_params(
            resampler, {k: True for k, _ in resampler.named_parameters()})
        params.update({f"resampler.{k}": p for k, p in trainable.items()})
        step = diffusion.make_stage2_step(unet, resampler, DDPMSchedule(), diffusion.Stage2Config(
            manga=mods.manga, ip_contrastive="fast"), env.group)
        trained = {"unet": unet, "resampler": resampler}
        if mode == "dp":
            wrap_ddp(step, trained, env)
        else:
            from diffsensei_tpu_torch.parallel.train import is_sharded

            params = fsdp_train(step, trained, frozen, params, env, inp["fsdp_min_size"])
            out["fsdp_sharded"] = sum(is_sharded(p) for p in params.values())
            out["fsdp_whole"] = sum(not is_sharded(p) for p in params.values())
        sgd = torch.optim.SGD(list(params.values()), lr=inp["lr"], momentum=0.9, foreach=False)
        losses, grads = [], None
        for _ in range(2):
            loss, metrics = step.forward(frozen, batch, None, **inp["draws"])
            loss.backward()
            if step.sync_grads is not None:
                step.sync_grads()
            metrics = reduce_metrics({**{k: v.detach() for k, v in metrics.items()},
                                      "loss": loss.detach(),
                                      "panels": diffusion._panel_count(batch)}, env.group)
            losses.append({k: float(v) for k, v in metrics.items()})
            if grads is None:
                grads = {k: full_state(p.grad).clone() for k, p in params.items()}
            sgd.step()
            sgd.zero_grad(set_to_none=True)
        out[mode] = dict(losses=losses, grads=grads,
                         params={k: full_state(p.detach()).clone() for k, p in params.items()})
    return out


def task_stage3_step(inp, rank, world):
    """A stage-3 step on this rank's rows under DDP, two SGD-with-momentum
    updates: losses (the ranks' mean), the synced gradients of the first,
    the trainables after the second."""
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
    from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
    from diffsensei_tpu_torch.parallel.mesh import host_rows, init_distributed
    from diffsensei_tpu_torch.parallel.train import reduce_metrics, wrap_ddp
    from diffsensei_tpu_torch.train import diffusion, mllm_step
    from diffsensei_tpu_torch.train.optim import make_optimizer

    env = init_distributed("cpu")
    mods = _tiny_modules(inp["state"])
    agent = ContinuousLVLM.build(inp["agent_config"], device="cpu")
    for name, sd in inp["agent_state"].items():
        getattr(agent, name).load_state_dict(sd)
    params = mllm_step.agent_trainables(agent)
    frozen = diffusion.FrozenDiffusionStack(
        vae=mods.vae, text_encoder=mods.text_encoder, text_encoder_2=mods.text_encoder_2,
        image_encoder=mods.image_encoder, magi_encoder=mods.magi_encoder,
        vae_scaling=mods.vae.config.scaling_factor)
    step = mllm_step.make_stage3_step(mods.unet, mods.resampler, agent, DDPMSchedule(),
                                      mllm_step.Stage3Config(manga=mods.manga), env.group)
    wrap_ddp(step, {"llm": agent.llm, "input_resampler": agent.input_resampler,
                    "output_resampler": agent.output_resampler}, env)
    batch = {k: host_rows(v, rank, world) for k, v in inp["batch"].items()}
    sgd = torch.optim.SGD(list(params.values()), lr=inp["lr"], momentum=0.9)
    losses, grads = [], None
    for _ in range(2):
        loss, metrics = step.forward(frozen, batch, None, **inp["draws"])
        loss.backward()
        metrics = reduce_metrics({**{k: v.detach() for k, v in metrics.items()},
                                  "loss": loss.detach(),
                                  "panels": diffusion._panel_count(batch)}, env.group)
        losses.append({k: float(v) for k, v in metrics.items()})
        if grads is None:
            grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                     for k, p in params.items()}
        sgd.step()
        sgd.zero_grad(set_to_none=True)
    return dict(losses=losses, grads=grads,
                params={k: p.detach().clone() for k, p in params.items()})


def _tp_llama_forward(case, group):
    """A LLaMA of this rank's shards on the model axis ``group``: logits and
    hidden state of a full forward, then of a cached prefill and one decode
    step."""
    from diffsensei_tpu_torch.models.mllm.llama import LlamaForCausalLM, init_caches

    cfg, ids = case["config"], case["ids"]
    with torch.device("meta"):
        llm = LlamaForCausalLM(cfg, lora_rank=case["lora_rank"], quantized=case["quantized"],
                               tp_group=group)
    llm.to_empty(device="cpu").load_state_dict(case["shards"][dist.get_rank(group)])
    b, s = ids.shape
    with torch.no_grad():
        logits, hidden, _ = llm(ids)
        caches = init_caches(cfg, b, s, tp=llm.tp_size)
        pre = s - 1
        pos = torch.arange(s)[None].expand(b, s)
        _, _, caches = llm(ids[:, :pre], positions=pos[:, :pre], caches=caches, cache_index=0)
        step, _, _ = llm(ids[:, pre:], positions=pos[:, pre:], caches=caches, cache_index=pre)
    return dict(logits=logits, hidden=hidden, decode=step, cache_shape=tuple(caches[0][0].shape),
                embed_rows=llm.embed_tokens.weight.shape[0])


def _tp_generate(case, group):
    """``generate`` of the whole agent cut into this rank's shards
    (``shard_agent``)."""
    from diffsensei_tpu_torch.models.mllm.llama import init_caches
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM, shard_agent

    agent = ContinuousLVLM.build(case["config"], quantized=case["quantized"], device="cpu")
    for name, sd in case["state"].items():
        getattr(agent, name).load_state_dict(sd)
    agent = shard_agent(agent, group)
    out = agent.generate(case["input_ids"], image_embeds=case["image_embeds"],
                         ids_cmp_mask=case["ids_cmp_mask"], **case["kwargs"])
    cache = init_caches(agent.llm.config, 1, 8, tp=agent.llm.tp_size)[0][0]
    return dict(out, cache_shape=tuple(cache.shape))


def _tp_host_int4(case, group):
    """The serve CLI's int4 load on the model axis: ``quantize_agent_on_host``
    with ``tp_group`` cuts this rank's shards on the host. Its LLaMA state
    against ``shard_llm`` of ``quantize_agent`` of the whole agent (the
    names whose dtype or bytes differ), and ``generate`` of both it and
    the unsharded int4 agent."""
    from diffsensei_tpu_torch.models.mllm.quant import quantize_agent, quantize_agent_on_host
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM
    from diffsensei_tpu_torch.parallel.tensor import shard_llm

    whole = ContinuousLVLM.build(case["config"], device="cpu")
    for name, sd in case["state"].items():
        getattr(whole, name).load_state_dict(sd)
    whole = quantize_agent(whole, bits=4)
    want = shard_llm(whole.llm, group).state_dict()
    meta = ContinuousLVLM.build(case["config"], device="cpu", init="none")
    agent = quantize_agent_on_host(meta, case["state"], bits=4, device="cpu", tp_group=group)
    got = agent.llm.state_dict()
    differ = sorted(set(got) ^ set(want)) + sorted(
        k for k in set(got) & set(want)
        if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k]))
    run = lambda a: a.generate(case["input_ids"], image_embeds=case["image_embeds"],
                               ids_cmp_mask=case["ids_cmp_mask"], **case["kwargs"])
    return dict(differ=differ, names=len(got), sharded=run(agent), whole=run(whole))


def _tp_stage3(case, env):
    """Two SGD-with-momentum steps of stage 3 on a ``(data, model)`` mesh,
    then one of ``make_optimizer``'s (global-norm clip and AdamW): the
    agent's LLaMA cut over the model axis (per-layer remat under the
    ``attn`` policy, its recompute repeating the collectives), DDP and the
    step's reductions over the data axis, each data rank with its rows of
    the global batch. Losses (the ranks' mean), this rank's synced
    gradients of the first step, its trainables after the second and the
    third (shards where they are cut) and the third step's global norm."""
    from diffsensei_tpu_torch.models.mllm.seed_x import ContinuousLVLM, shard_agent
    from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
    from diffsensei_tpu_torch.parallel.mesh import (
        MeshSpec, data_group, host_rows, make_mesh, model_group)
    from diffsensei_tpu_torch.parallel.train import reduce_metrics, wrap_ddp
    from diffsensei_tpu_torch.train import diffusion, mllm_step
    from diffsensei_tpu_torch.train.optim import make_optimizer

    mesh = make_mesh(MeshSpec(**case["mesh"]), device="cpu")
    dgroup, mgroup = data_group(mesh), model_group(mesh)
    drank, dworld = dist.get_rank(dgroup), dist.get_world_size(dgroup)
    mods = _tiny_modules(case["state"])
    agent = ContinuousLVLM.build(case["agent_config"], device="cpu", remat=True,
                                 remat_policy="attn")
    for name, sd in case["agent_state"].items():
        getattr(agent, name).load_state_dict(sd)
    agent = shard_agent(agent, mgroup)
    params = mllm_step.agent_trainables(agent)
    frozen = diffusion.FrozenDiffusionStack(
        vae=mods.vae, text_encoder=mods.text_encoder, text_encoder_2=mods.text_encoder_2,
        image_encoder=mods.image_encoder, magi_encoder=mods.magi_encoder,
        vae_scaling=mods.vae.config.scaling_factor)
    step = mllm_step.make_stage3_step(mods.unet, mods.resampler, agent, DDPMSchedule(),
                                      mllm_step.Stage3Config(manga=mods.manga), dgroup)
    wrap_ddp(step, {"llm": agent.llm, "input_resampler": agent.input_resampler,
                    "output_resampler": agent.output_resampler}, env, group=dgroup)
    batch = {k: host_rows(v, drank, dworld) for k, v in case["batch"].items()}
    sgd = torch.optim.SGD(list(params.values()), lr=case["lr"], momentum=0.9)
    adamw = make_optimizer(list(params.values()), **case["adamw"])
    losses, grads, norm = [], None, None
    snapshot = lambda: {k: p.detach().clone() for k, p in params.items()}
    for s in range(3):
        if s == 2:
            after_sgd = snapshot()
        loss, metrics = step.forward(frozen, batch, None, **case["draws"])
        loss.backward()
        metrics = reduce_metrics({**{k: v.detach() for k, v in metrics.items()},
                                  "loss": loss.detach()}, dgroup)
        losses.append({k: float(v) for k, v in metrics.items()})
        if grads is None:
            grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                     for k, p in params.items()}
        if s < 2:
            sgd.step()
            sgd.zero_grad(set_to_none=True)
        else:
            norm = float(adamw._global_norm(
                [p.grad if p.grad is not None else torch.zeros_like(p) for p in adamw.params],
                adamw.params))
            adamw.step()
    return dict(losses=losses, grads=grads, data_rank=drank,
                model_rank=dist.get_rank(mgroup), params=after_sgd, norm=norm,
                adamw_params=snapshot(),
                frozen={k: p.detach().clone() for k, p in agent.llm.named_parameters()
                        if not p.requires_grad})


def task_model_axis(inp, rank, world):
    """The model axis over the whole group: the LLaMA's forward and cached
    decode in each layout of ``inp["llama"]``, the agent's ``generate``
    (``inp["generate"]``), its int4 host load (``inp["host_int4"]``), then
    stage-3 steps on a ``(data, model)`` mesh (``inp["stage3"]``)."""
    from diffsensei_tpu_torch.parallel.mesh import init_distributed

    env = init_distributed("cpu")
    out = {"llama": {name: _tp_llama_forward(case, dist.group.WORLD)
                     for name, case in inp.get("llama", {}).items()},
           "generate": {name: _tp_generate(case, dist.group.WORLD)
                        for name, case in inp.get("generate", {}).items()}}
    if "host_int4" in inp:
        out["host_int4"] = _tp_host_int4(inp["host_int4"], dist.group.WORLD)
    if "stage3" in inp:
        out["stage3"] = _tp_stage3(inp["stage3"], env)
    return out


TASKS = {"ring": task_ring, "serve": task_serve, "train_step": task_train_step,
         "stage3_step": task_stage3_step, "model_axis": task_model_axis}


def main(task: str, tmp: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
        out = TASKS[task](inp, rank, world)
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    if "jax" in sys.modules:
        raise SystemExit("a rank imported jax")
