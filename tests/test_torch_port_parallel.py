"""The port's data-parallel layer against the JAX package (CPU, fp32).

Multi-rank cases run their ranks as separate processes over gloo
(``tests/torch_parallel_workers.py``: a ``file://`` store in ``tmp_path``,
one thread a rank, no jax in the ranks), several checks a spawn; the JAX
side runs on its 8-virtual-device CPU mesh (``tests/conftest.py``). Inputs
come from numpy seeds. Tolerances: the ring 3e-4 (``tests/test_ring_attention.py``),
the UNet, the pipelines and a train step's losses, gradients and parameters
5e-4 of each tensor's largest magnitude; ``fsdp_spec`` and the dataset's
bytes exactly. The equivalence steps use SGD with momentum: AdamW's first
step is about ``lr * sign(g)``, which turns the rounding of reordered
reductions into differences.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsensei_tpu.core.config import PipelineConfig as JPipelineConfig
from diffsensei_tpu.data import bucket_dataset as jbd
from diffsensei_tpu.models.schedulers import DDPMSchedule as JDDPM
from diffsensei_tpu.models.unet import attention_levels
from diffsensei_tpu.ops.attention import attention_ref as jattention_ref
from diffsensei_tpu.ops.masked_ip import build_ip_attention_bias
from diffsensei_tpu.ops.ring_attention import ring_attention_sharded as jring
from diffsensei_tpu.parallel import mesh as jmesh
from diffsensei_tpu.pipelines.pipeline import DiffSenseiPipeline as JPipeline
from diffsensei_tpu.train import diffusion as jdiff, optim as joptim

from diffsensei_tpu_torch.data import bucket_dataset as tbd
from diffsensei_tpu_torch.ops.attention import attention_ref
from diffsensei_tpu_torch.ops.ring_attention import (
    chunk_attention, chunk_attention_ref, merge_partials, ring_schedule)
from diffsensei_tpu_torch.parallel import mesh as tmesh
from diffsensei_tpu_torch.serve import cli as serve_cli
from diffsensei_tpu_torch.train import cli as train_cli
from diffsensei_tpu_torch.utils import from_jax

from tests.torch_parallel_workers import REPO, run_ranks
from tests.torch_port_util import mangazero_pages, tiny_pipelines

torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.array(a))


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=name)


def _jax_mesh(n):
    return jmesh.make_mesh(jmesh.MeshSpec(data=n, model=1), jax.devices()[:n])


@pytest.fixture(scope="module")
def stacks():
    """(JAX pipeline, port pipeline) of the tiny configs with the same weights,
    the port's VAE encoder included."""
    jpipe, tpipe = tiny_pipelines()
    tpipe.m.vae.load_state_dict(from_jax.to_tensors(
        from_jax.vae(jpipe.m.vae_params, jpipe.m.vae.config)))
    return jpipe, tpipe


def _port_state(tpipe):
    return {name: mod.state_dict() for name, mod in tpipe.m.networks().items()}


# ---------------------------------------------------------------------------
# the mesh layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(), (8,), (64, 64), (255, 257), (256, 257), (320, 640, 3, 3),
                                   (3, 3, 320, 640), (1280,), (77, 2048), (4, 1024, 16)])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("min_size", [0, 1024, jmesh.FSDP_MIN_SIZE])
def test_fsdp_spec_matches_jax(shape, shards, min_size):
    want = jmesh.fsdp_spec(shape, shards, min_size)
    got = tmesh.fsdp_spec(shape, shards, min_size)
    want_dim = next((i for i, a in enumerate(want) if a == jmesh.DATA_AXIS), None)
    assert got == want_dim
    assert tmesh.FSDP_MIN_SIZE == jmesh.FSDP_MIN_SIZE


def test_mesh_spec_refuses_a_model_axis():
    """A model axis of 2 builds a (data, model) spec; an axis of no rank
    is refused."""
    assert tmesh.MeshSpec(data=4).num_devices == 4
    assert tmesh.MeshSpec(data=2, model=2).num_devices == 4
    for data, model in ((2, 0), (0, 2), (1, -1)):
        with pytest.raises(ValueError, match="at least one rank"):
            tmesh.MeshSpec(data=data, model=model)


def test_rows_of_a_rank():
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(tmesh.shard_batch({"x": x}, 1, 3)["x"], x[2:4])
    assert torch.equal(tmesh.host_rows(x, 1, 3), x[1::3])
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_batch({"x": x}, 0, 4)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------
def _qkv(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(3)]


RING_CASES = {"s256_h2": (0, 2, 2, 256, 32), "s512_h4": (0, 2, 4, 512, 32)}


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_on_ranks_matches_jax(tmp_path, n):
    """``ring_attention_sharded`` on n gloo ranks against the JAX ring on an
    n-device mesh (3e-4), the dispatcher's ``cp_group`` path against the
    plain one, and a sequence the ranks do not divide on the plain path."""
    qkv = {key: _qkv(*case) for key, case in RING_CASES.items()}
    dispatch = _qkv(1, 2, 4, 256, 32)
    ragged = _qkv(2, 1, 2, 4 * n + 1, 32)
    outs = run_ranks("ring", tmp_path, n, {
        "qkv": {k: [T(a) for a in v] for k, v in qkv.items()},
        "dispatch": [T(a) for a in dispatch], "ragged": [T(a) for a in ragged]})
    mesh = _jax_mesh(n)
    for key, (q, k, v) in qkv.items():
        with mesh:
            want = np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh))
        for r, out in enumerate(outs):
            np.testing.assert_allclose(out[key].numpy(), want, rtol=3e-4, atol=3e-4,
                                       err_msg=f"{key} rank {r}")
    plain = attention_ref(*[T(a) for a in dispatch])
    for out in outs:
        np.testing.assert_allclose(out["dispatch"].numpy(), plain.numpy(), rtol=3e-4, atol=3e-4)
        assert torch.equal(out["ragged"], attention_ref(*[T(a) for a in ragged]))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_schedule_matches_jax(n):
    """The one-process schedule of the ring (``chunk_attention`` and
    ``merge_partials`` in the ring's order, n² chunks) against the JAX ring
    on an n-device mesh."""
    q, k, v = _qkv(3, 2, 2, 256, 32)
    mesh = _jax_mesh(n)
    with mesh:
        want = np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh))
    got = ring_schedule(T(q), T(k), T(v), n)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jattention_ref(q, k, v)),
                               rtol=3e-4, atol=3e-4)


def test_chunk_and_merge_match_jax():
    """One chunk's ``(o, lse)`` and the merge of two against the whole."""
    from diffsensei_tpu.ops.ring_attention import _chunk_attention_ref as jchunk

    q, k, v = _qkv(4, 1, 2, 64, 32)
    scale = 32 ** -0.5
    o, lse = chunk_attention(T(q), T(k), T(v), scale)
    jo, jlse = jchunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    _close(o, jo, 1e-5, "o")
    _close(lse, jlse, 1e-5, "lse")
    halves = [chunk_attention_ref(T(q), T(k[:, :, i:i + 32]), T(v[:, :, i:i + 32]), scale)
              for i in (0, 32)]
    mo, mlse = merge_partials(*halves[0], *halves[1])
    _close(mo, jo, 1e-5, "merged o")
    _close(mlse, jlse, 1e-5, "merged lse")


# ---------------------------------------------------------------------------
# the context-parallel UNet and the mesh pipelines
# ---------------------------------------------------------------------------
def _unet_inputs(jm):
    manga, ucfg = jm.manga, jm.unet.config
    rng = np.random.default_rng(2)
    lh = lw = 8
    sample = rng.normal(size=(2, lh, lw, ucfg.in_channels)).astype(np.float32)
    t = np.full((2,), 500.0, np.float32)
    ctx = rng.normal(size=(2, 77, ucfg.cross_attention_dim)).astype(np.float32)
    pooled = np.zeros((2, ucfg.pooled_projection_dim), np.float32)
    time_ids = np.full((2, 6), 64.0, np.float32)
    ip = rng.normal(size=(2, manga.num_context_image_tokens,
                          ucfg.cross_attention_dim)).astype(np.float32)
    bbox = np.tile(np.asarray([[[0.0, 0.0, 0.5, 1.0], [0.5, 0.0, 1.0, 1.0]]], np.float32),
                   (2, 1, 1))
    biases = {lv: np.asarray(build_ip_attention_bias(jnp.asarray(bbox), lh >> lv, lw >> lv,
                                                     manga.num_vision_tokens,
                                                     manga.num_dummy_tokens))
              for lv in attention_levels(ucfg)}
    return (sample, t, ctx, pooled, time_ids), dict(ip_hidden_states=ip, ip_attn_bias=biases,
                                                    ip_scale=0.6)


def _prompt_ids(seed):
    rng = np.random.default_rng(seed)
    mk = lambda: rng.integers(1, 255, (1, 77)).astype(np.int32)
    return dict(ids=mk(), neg_ids=mk(), ids_2=mk(), neg_ids_2=mk())


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return T(tree) if isinstance(tree, np.ndarray) else tree


def test_context_parallel_unet_and_mesh_pipelines_match_jax(tmp_path, stacks):
    """On 2 gloo ranks: the tiny UNet with ``cp_min_seq=8`` against the JAX
    ``cp_mesh`` forward; the context-parallel pipeline (64x64, min_seq 8,
    characters and a dialog box) and the batch-sharded pipeline (2 samples:
    4 CFG rows, 2 a rank) against the JAX pipelines on a 2-device mesh, fed
    the same ``latents=``; all 5e-4. Every rank holds the whole result."""
    jpipe, tpipe = stacks
    jm = jpipe.m
    args, kwargs = _unet_inputs(jm)
    mesh = _jax_mesh(2)
    jargs = [jnp.asarray(a) for a in args]
    jkw = dict(kwargs, ip_hidden_states=jnp.asarray(kwargs["ip_hidden_states"]),
               ip_attn_bias={lv: jnp.asarray(b) for lv, b in kwargs["ip_attn_bias"].items()})
    with mesh:
        want_unet = np.asarray(jm.unet.clone(cp_mesh=mesh, cp_min_seq=8).apply(
            jm.unet_params, *jargs, **jkw))

    rng = np.random.default_rng(5)
    common = dict(height=64, width=64, num_inference_steps=2, snap_to_buckets=False)
    cp_call = dict(common, num_samples=1, prompt_ids=_prompt_ids(3),
                   ip_pixel_values=rng.uniform(0, 1, (2, 224, 224, 3)).astype(np.float32),
                   ip_bbox=[[0, 0, .5, 1], [.5, 0, 1, 1]], dialog_bbox=[[.1, 0, .5, .2]],
                   latents=rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
    batched_call = dict(common, num_samples=2, prompt_ids=_prompt_ids(4),
                        ip_pixel_values=np.zeros((2, 224, 224, 3), np.float32),
                        ip_bbox=[[0, 0, .5, 1], [.5, 0, 1, 1]],
                        latents=rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    to_jax = lambda call: {k: ({n: jnp.asarray(a) for n, a in v.items()} if k == "prompt_ids"
                               else jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                           for k, v in call.items()}
    jcp = JPipeline(jm, JPipelineConfig(context_parallel=True, context_parallel_min_seq=8),
                    mesh=mesh)
    with mesh:
        want_cp = np.asarray(jcp(**to_jax(cp_call)))
        want_batched = np.asarray(JPipeline(jm, mesh=mesh)(**to_jax(batched_call)))

    outs = run_ranks("serve", tmp_path, 2, {
        "state": _port_state(tpipe), "unet_args": (_as_torch(list(args)), _as_torch(kwargs)),
        "cp_call": _as_torch(cp_call), "batched_call": _as_torch(batched_call)})
    for r, out in enumerate(outs):
        _close(out["unet_cp"], want_unet, 5e-4, f"unet rank {r}")
        _close(out["pipeline_cp"], want_cp, 5e-4, f"cp pipeline rank {r}")
        _close(out["pipeline_batched"], want_batched, 5e-4, f"batched pipeline rank {r}")
        assert out["unet_cp_after"], "the pipeline left the ring switched on"
    assert want_batched.shape == (2, 64, 64, 3)


# ---------------------------------------------------------------------------
# a stage-2 step under DDP and FSDP
# ---------------------------------------------------------------------------
def _global_batch(manga, b=4, hw=32, sources=2):
    rng = np.random.default_rng(13)
    i = manga.max_num_ips
    return {
        "pixel_values": rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
        "text_input_ids": rng.integers(1, 250, (b, 77)).astype(np.int32),
        "text_input_ids_2": rng.integers(1, 250, (b, 77)).astype(np.int32),
        "ip_pixel_values": rng.uniform(0, 1, (b, i, sources, 224, 224, 3)).astype(np.float32),
        "magi_pixel_values": rng.uniform(0, 1, (b, i, sources, 224, 224, 3)).astype(np.float32),
        "ip_exists": rng.integers(0, 2, (b, i, sources)).astype(np.float32),
        "ip_bbox": rng.uniform(0, 1, (b, i, 4)).astype(np.float32),
        "dialog_bbox": rng.uniform(0, 1, (b, manga.max_num_dialogs, 4)).astype(np.float32),
        "original_size": np.full((b, 2), float(hw), np.float32),
        "crop_coords_top_left": np.zeros((b, 2), np.float32),
        "target_size": np.full((b, 2), float(hw), np.float32),
        # a padded batch: rank 0 holds rows 0 and 2 (2 panels), rank 1 rows 1 and 3 (1)
        "sample_mask": np.asarray([1, 1, 1, 0], np.float32),
    }


def test_stage2_step_under_dp_and_fsdp_matches_jax(tmp_path, stacks):
    """Two SGD-with-momentum steps of stage 2 (``new`` mode, the fast
    contrastive loss over the global batch) on 2 gloo ranks, each holding
    rows ``[rank::2]`` of a padded batch of 4 with unequal panel counts,
    under DDP and under FSDP (parameters of at least 1024 elements sharded):
    the global losses, the synced gradients of the first step and the
    parameters after the second against the JAX single-device step on the
    global batch, 5e-4."""
    jpipe, tpipe = stacks
    jm = jpipe.m
    manga = jm.manga
    batch = _global_batch(manga)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.key(1)
    mean, _ = jm.vae.apply(jm.vae_params, jbatch["pixel_values"], method=jm.vae.encode)
    rng_n, rng_t = jax.random.split(jax.random.fold_in(rng, 1))
    draws = dict(latent_noise=np.asarray(jax.random.normal(jax.random.fold_in(rng, 0),
                                                           mean.shape, mean.dtype)),
                 noise=np.asarray(jax.random.normal(rng_n, mean.shape, mean.dtype)),
                 timesteps=np.asarray(jax.random.randint(rng_t, (4,), 0, 1000)))

    jfrozen = jdiff.FrozenDiffusionStack(
        vae=jm.vae, vae_params=jm.vae_params, text_encoder=jm.text_encoder,
        text_encoder_params=jm.text_encoder_params, text_encoder_2=jm.text_encoder_2,
        text_encoder_2_params=jm.text_encoder_2_params, image_encoder=jm.image_encoder,
        image_encoder_params=jm.image_encoder_params, magi_encoder=jm.magi_encoder,
        magi_encoder_params=jm.magi_encoder_params, vae_scaling=jm.vae.config.scaling_factor)
    jstep = jdiff.make_stage2_step(jm.unet, jm.resampler, JDDPM(), jdiff.Stage2Config(
        manga=manga, ip_contrastive="fast"))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jfrozen, jbatch, rng), has_aux=True))
    mask = {"unet": joptim.unet_trainable_mask(jm.unet_params, "new"),
            "resampler": jax.tree.map(lambda _: True, jm.resampler_params)}
    lr = 0.1
    params = {"unet": jm.unet_params, "resampler": jm.resampler_params}
    losses, grads0, buf = [], None, None
    for _ in range(2):
        (loss, _), g = grad_fn(params)
        losses.append(float(loss))
        grads0 = g if grads0 is None else grads0
        buf = g if buf is None else jax.tree.map(lambda b_, g_: 0.9 * b_ + g_, buf, g)
        params = jax.tree.map(lambda p, b_, m: p - lr * b_ if m else p, params, buf, mask)

    def by_port_name(tree):
        out = {f"unet.{k}": v for k, v in from_jax.sdxl_unet(tree["unet"], jm.unet.config).items()}
        out.update({f"resampler.{k}": v for k, v in
                    from_jax.resampler(tree["resampler"], jm.resampler.config.depth).items()})
        return out

    want_grads, want_params = by_port_name(grads0), by_port_name(params)
    outs = run_ranks("train_step", tmp_path, 2, {
        "state": _port_state(tpipe), "batch": _as_torch(batch), "draws": _as_torch(draws),
        "lr": lr, "fsdp_min_size": 1024})
    for r, out in enumerate(outs):
        assert out["fsdp_sharded"] > 0 and out["fsdp_whole"] > 0
        for mode in ("dp", "fsdp"):
            got = out[mode]
            for s, want in enumerate(losses):
                _close(torch.tensor(got["losses"][s]["loss"]), want, 5e-4, f"{mode} loss {s}")
            assert got["losses"][0]["panels"] == 3.0
            assert got["grads"].keys() == got["params"].keys()
            for name in got["grads"]:
                _close(got["grads"][name], want_grads[name], 5e-4, f"{mode} grad {name}")
                _close(got["params"][name], want_params[name], 5e-4, f"{mode} param {name}")
    # every rank ends with the same trainables
    for mode in ("dp", "fsdp"):
        for name, p in outs[0][mode]["params"].items():
            assert torch.equal(p, outs[1][mode]["params"][name]), (mode, name)


def _stage3_batch_fields(batch, manga, vocab):
    """``batch`` (4 rows) with stage 3's fields: token streams whose rows
    ``[0::2]`` and ``[1::2]`` hold different counts of supervised tokens and
    generation images, and target crops; the image ladder at the top of a
    vocabulary of ``vocab``."""
    from diffsensei_tpu_torch.data import mllm_dataset as tdata

    b, iv = 4, manga.num_ip_tokens
    ladder = list(range(vocab - iv - 2, vocab))
    spec = tdata.MLLMTokenSpec(bos_id=1, eos_id=2, pad_id=0, boi_id=ladder[0],
                               eoi_id=ladder[-1], img_ids=ladder[1:-1],
                               encode_text=lambda t: [(ord(c) % 40) + 3 for c in t if c != " "])
    rows = [tdata.build_mllm_token_stream(spec.encode_text("ab" * (1 + 3 * k)), spec, [], 40)
            for k in range(b)]
    streams = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    streams["embeds_gen_mask"][3] = False       # rank 1 holds one generation image, rank 0 two
    supervised = np.flatnonzero(streams["mllm_labels"][2] != -100)
    streams["mllm_labels"][2, supervised[0]] = -100   # and fewer supervised tokens
    rng = np.random.default_rng(8)
    batch.update({k: streams[k] for k in ("mllm_input_ids", "mllm_labels", "ids_cmp_mask",
                                          "ids_gen_mask", "embeds_cmp_mask", "embeds_gen_mask")})
    batch["target_ip_pixel_values"] = rng.uniform(
        0, 1, (b, manga.max_num_ips, 224, 224, 3)).astype(np.float32)
    batch["target_magi_pixel_values"] = rng.uniform(
        0, 1, (b, manga.max_num_ips, 224, 224, 3)).astype(np.float32)
    tokens = (streams["mllm_labels"][:, 1:] != -100).sum(axis=1)
    assert tokens[0::2].sum() != tokens[1::2].sum()
    return batch


def test_stage3_step_under_dp_matches_jax(tmp_path, stacks):
    """Two SGD-with-momentum steps of stage 3 (the tiny agent, LoRA rank 4)
    under DDP on 2 gloo ranks, each with rows ``[rank::2]`` of a batch of 4
    whose ranks hold different counts of panels, supervised tokens and
    generation images, against the JAX single-device step on the global
    batch: the global loss and its parts, the first step's synced
    gradients, the trainables after the second, 5e-4."""
    from diffsensei_tpu.core.config import (
        AgentConfig, LlamaConfig, LoRAConfig, QwenResamplerConfig)
    from diffsensei_tpu.models.mllm import peft as jpeft
    from diffsensei_tpu.train import mllm_step as jstep3
    from tests.torch_port_util import agents

    jpipe, tpipe = stacks
    jm = jpipe.m
    manga = jm.manga
    llm = LlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=48, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_position_embeddings=64)
    iv, kv = manga.num_ip_tokens, jm.unet.config.cross_attention_dim
    cfg = AgentConfig(
        llm=llm, lora=LoRAConfig(rank=4),
        input_resampler=QwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                            embed_dim=llm.hidden_size, num_heads=4, kv_dim=kv),
        output_resampler=QwenResamplerConfig(grid_size=2, num_queries_override=iv,
                                             embed_dim=kv, num_heads=4, kv_dim=llm.hidden_size))
    jagent, tagent = agents(cfg, seed=9)

    b = 4
    batch = _stage3_batch_fields(_global_batch(manga, sources=1), manga, 96)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.key(2)
    mean, _ = jm.vae.apply(jm.vae_params, jbatch["pixel_values"], method=jm.vae.encode)
    rng_n, rng_t = jax.random.split(jax.random.fold_in(rng, 1))
    draws = dict(latent_noise=np.asarray(jax.random.normal(jax.random.fold_in(rng, 0),
                                                           mean.shape)),
                 noise=np.asarray(jax.random.normal(rng_n, mean.shape)),
                 timesteps=np.asarray(jax.random.randint(rng_t, (b,), 0, 1000)))
    jfrozen = jdiff.FrozenDiffusionStack(
        vae=jm.vae, vae_params=jm.vae_params, text_encoder=jm.text_encoder,
        text_encoder_params=jm.text_encoder_params, text_encoder_2=jm.text_encoder_2,
        text_encoder_2_params=jm.text_encoder_2_params, image_encoder=jm.image_encoder,
        image_encoder_params=jm.image_encoder_params, magi_encoder=jm.magi_encoder,
        magi_encoder_params=jm.magi_encoder_params, unet_params=jm.unet_params,
        resampler_params=jm.resampler_params, vae_scaling=jm.vae.config.scaling_factor)
    jstep = jstep3.make_stage3_step(jm.unet, jm.resampler, jagent, JDDPM(),
                                    jstep3.Stage3Config(manga=manga))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jfrozen, jbatch, rng), has_aux=True))
    params = {"llm": jagent.llm_params, "input_resampler": jagent.input_resampler_params,
              "output_resampler": jagent.output_resampler_params}
    mask = {"llm": jpeft.lora_trainable_mask(params["llm"]),
            "input_resampler": jax.tree.map(lambda _: True, params["input_resampler"]),
            "output_resampler": jax.tree.map(lambda _: True, params["output_resampler"])}
    lr = 0.1
    metrics_want, grads0, buf = [], None, None
    for _ in range(2):
        (loss, metrics), g = grad_fn(params)
        metrics_want.append({"loss": float(loss), **{k: float(v) for k, v in metrics.items()}})
        g = jax.tree.map(lambda g_, m: g_ if m else jnp.zeros_like(g_), g, mask)
        grads0 = g if grads0 is None else grads0
        buf = g if buf is None else jax.tree.map(lambda b_, g_: 0.9 * b_ + g_, buf, g)
        params = jax.tree.map(lambda p, b_, m: p - lr * b_ if m else p, params, buf, mask)
    by_name = lambda tree: {f"{net}.{k}": v for net, sd in from_jax.agent_tree(tree).items()
                            for k, v in sd.items()}
    want_grads, want_params = by_name(grads0), by_name(params)

    outs = run_ranks("stage3_step", tmp_path, 2, {
        "state": _port_state(tpipe), "agent_config": tagent.config,
        "agent_state": {n: getattr(tagent, n).state_dict()
                        for n in ("llm", "input_resampler", "output_resampler")},
        "batch": _as_torch(batch), "draws": _as_torch(draws), "lr": lr})
    for r, out in enumerate(outs):
        for s, want in enumerate(metrics_want):
            for k in ("loss", "loss_diffusion", "loss_lm", "loss_rec", "loss_mllm"):
                _close(torch.tensor(out["losses"][s][k]), want[k], 5e-4, f"rank {r} {k} {s}")
        assert out["grads"].keys() == out["params"].keys()
        for name in out["grads"]:
            _close(out["grads"][name], want_grads[name], 5e-4, f"grad {name}")
            _close(out["params"][name], want_params[name], 5e-4, f"param {name}")
    for name, p in outs[0]["params"].items():
        assert torch.equal(p, outs[1]["params"][name]), name


# ---------------------------------------------------------------------------
# the bucket dataset's per-rank rows and context image
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("context", [False, True])
def test_bucket_dataset_rank_rows_and_context_image_are_the_jax_bytes(context):
    anns = mangazero_pages(np.random.default_rng(8))
    tok = lambda text: (np.arange(77) * 7 + len(text)) % 250
    kw = dict(max_num_ips=3, max_num_ip_sources=2, max_num_dialogs=2, batch_size=2,
              i_drop_rate=0.2, t_drop_rate=0.3, c_drop_rate=0.3, data_parallel=2,
              load_context_image=context)
    jds = jbd.MangaTrainSizeBucketDataset("", "", tok, config=jbd.BucketDatasetConfig(**kw),
                                          annotations=anns)
    tds = tbd.MangaTrainSizeBucketDataset("", "", tok, config=tbd.BucketDatasetConfig(**kw),
                                          annotations=anns)
    whole = list(tds.batches(shuffle=True, seed=5, num_hosts=1))
    for host in (0, 1):
        want = list(jds.batches(shuffle=True, seed=5, num_workers=2, host_id=host, num_hosts=2))
        got = list(tds.batches(shuffle=True, seed=5, num_workers=2, host_id=host, num_hosts=2))
        assert len(got) == len(want) == tds.num_batches() > 1
        for g, w, full in zip(got, want, whole):
            assert g.keys() == w.keys()
            assert ("context_pixel_values" in g) == ("drop_context" in g) == context
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
                assert np.array_equal(g[k], full[k][host::2]), k
    if context:
        drops = np.concatenate([b["drop_context"] for b in whole])
        assert 0 < drops.sum() < len(drops)
    for ds in (jds, tds):
        with pytest.raises(ValueError, match="divisible by num_hosts"):
            next(iter(ds.batches(seed=5, host_id=0, num_hosts=3)))


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
def _write_run(root, parallel, steps=1):
    root.mkdir(parents=True, exist_ok=True)
    anns = mangazero_pages(np.random.default_rng(9))
    for ann in anns:
        ann.pop("image").save(root / ann["image_path"])
    (root / "annotations.json").write_text(json.dumps(anns))
    cfg = root / "config.yaml"
    cfg.write_text(f"""
stage: condition
model:
  preset: tiny
  unet_trained_parameters: new
  ip_contrastive_loss: fast
  remat: true
train_data:
  ann_path: {root}/annotations.json
  image_root: {root}
  batch_size: 2
  max_num_ip_sources: 2
  num_workers: 1
optimizer: {{lr: 1.0e-3, weight_decay: 0.01, max_grad_norm: 1.0}}
lr_scheduler: {{name: constant}}
trainer:
  parallel: {parallel}
  fsdp_min_size: 1024
  max_train_steps: {steps}
  log_every: 1
  checkpoint_every: 1
  seed: 0
""")
    return cfg


def _torchrun(cfg, log_dir, *extra):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "diffsensei_tpu_torch.train.cli", "--config", os.fspath(cfg), "--device",
           "cpu", "--log_dir", os.fspath(log_dir), *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    for name, p in procs.items():
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, f"{name}:\n{log[-4000:]}"


def _checkpoint(log_dir, step):
    return torch.load(log_dir / f"step-{step}" / "ckpt.pt", weights_only=False)["state"]


def test_train_cli_under_dp_and_fsdp_on_two_ranks(tmp_path):
    """``trainer.parallel: dp`` and ``fsdp`` through the train CLI under
    ``torch.distributed.run`` on 2 CPU ranks: one step, then resumed to a
    second. Rank 0 alone writes: one ``metrics.jsonl`` line a step and
    whole tensors under the names and shapes of a single-process
    checkpoint; the losses are finite and the trainables move."""
    single = tmp_path / "single"
    train_cli.main(["--config", os.fspath(_write_run(tmp_path / "data_single", "dp")),
                    "--device", "cpu", "--log_dir", os.fspath(single)])
    ref = _checkpoint(single, 1)
    runs = {mode: (_write_run(tmp_path / f"data_{mode}", mode), tmp_path / mode)
            for mode in ("dp", "fsdp")}
    _wait({mode: _torchrun(cfg, log) for mode, (cfg, log) in runs.items()})
    _wait({mode: _torchrun(cfg, log, "--resume", "--max_train_steps", "2")
           for mode, (cfg, log) in runs.items()})
    for mode, (_, log) in runs.items():
        assert sorted(p.name for p in log.iterdir()) == ["metrics.jsonl", "step-1", "step-2"]
        records = [json.loads(line) for line in (log / "metrics.jsonl").read_text().splitlines()]
        assert [r["step"] for r in records] == [1, 2], mode
        assert all(np.isfinite(r["loss"]) and r["panels"] >= 1 for r in records), mode
        first, second = _checkpoint(log, 1), _checkpoint(log, 2)
        assert second["step"] == 2 and first["step"] == 1
        assert first["params"].keys() == ref["params"].keys(), mode
        for name, p in ref["params"].items():
            assert first["params"][name].shape == p.shape and not first["params"][name].is_meta
        opt, ref_opt = first["optimizer"]["adamw"]["state"], ref["optimizer"]["adamw"]["state"]
        assert opt.keys() == ref_opt.keys()
        for i, st in ref_opt.items():
            assert {k: v.shape for k, v in opt[i].items()} == {k: v.shape for k, v in st.items()}
        assert any(not torch.equal(first["params"][k], second["params"][k])
                   for k in first["params"]), mode


def test_serve_cli_with_context_parallel_writes_a_panel(tmp_path):
    """``--context-parallel`` as a world of one on the CPU: the request runs
    over the mesh and rank 0 writes the panel."""
    out = tmp_path / "panel.png"
    paths = serve_cli.main(["--device", "cpu", "--preset", "tiny", "--context-parallel",
                            "--height", "128", "--width", "128", "--steps", "2",
                            "--out", os.fspath(out)])
    assert paths == [os.fspath(out)] and out.stat().st_size > 0
