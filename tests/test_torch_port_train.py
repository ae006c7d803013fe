"""The PyTorch port's training path against the JAX package (CPU, fp32).

Inputs come from numpy seeds; the JAX side runs as its own tests run it
(flash attention in Pallas interpret mode, the train steps on the tiny stack).
Both stacks carry the same weights (``tests/torch_port_util.tiny_pipelines``),
and the port's ``loss_fn`` is fed the JAX step's own draws (latent sample
noise, diffusion noise, timesteps). Tolerances: the flash backward 2e-4
(the JAX package's own bound against its oracle), GroupNorm+SiLU, the
schedule, the VAE encoder and the losses 1e-5, a train step's loss,
gradients and updated parameters 5e-4 of each tensor's largest magnitude.
"""

import copy
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffsensei_tpu.data import bucket_dataset as jbd
from diffsensei_tpu.models.projection import ImageProjDummyModel as JImageProjDummyModel
from diffsensei_tpu.models.schedulers import DDPMSchedule as JDDPM
from diffsensei_tpu.ops import flash_attention as jfa
from diffsensei_tpu.ops.groupnorm import groupnorm_silu_ref as j_groupnorm_silu_ref
from diffsensei_tpu.train import diffusion as jdiff, losses as jlosses, optim as joptim

from diffsensei_tpu_torch.data import bucket_dataset as tbd
from diffsensei_tpu_torch.data.loader import PrefetchLoader
from diffsensei_tpu_torch.models.projection import ImageProjDummyModel as TImageProjDummyModel
from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
from diffsensei_tpu_torch.models.vae import sample_latent
from diffsensei_tpu_torch.ops import flash_attention as tfa, groupnorm as tgn
from diffsensei_tpu_torch.train import cli, diffusion as tdiff, losses as tlosses, optim as toptim
from diffsensei_tpu_torch.train.checkpoint import CheckpointManager, export_weights, load_weights
from diffsensei_tpu_torch.train.runner import RunConfig, run_training
from diffsensei_tpu_torch.utils import from_jax

from tests.torch_port_util import mangazero_pages, port_names, random_tree, tiny_pipelines

torch.set_num_threads(1)

T = lambda a: torch.from_numpy(np.array(a))      # numpy/JAX array -> CPU tensor


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=name)


# ---------------------------------------------------------------------------
# kernels' plain twins and autograd Functions (B2/B4, B3)
# ---------------------------------------------------------------------------
def _cos_weights(shape):
    return np.cos(np.arange(int(np.prod(shape)), dtype=np.float32)).reshape(shape)


@pytest.mark.parametrize("b,h,sq,sk,d,causal,with_bias", [
    (1, 2, 256, 256, 64, False, False),
    (1, 2, 256, 256, 64, True, False),
    (1, 2, 384, 320, 64, False, False),    # both tails ragged
    (1, 2, 256, 320, 64, True, False),
    (2, 2, 256, 256, 32, False, True),     # bias broadcast over heads
])
def test_flash_backward_matches_jax(b, h, sq, sk, d, causal, with_bias):
    """``FlashAttentionFn`` (B1 forward, the B2/B4 twin backward on the CPU)
    and ``flash_attention_bwd`` against JAX's flash gradients in interpret
    mode, the cases of ``tests/test_flash_backward.py``."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32) for s in (sq, sk, sk))
    bias = (rng.choice([0.0, -10000.0], size=(b, 1, sq, sk)).astype(np.float32)
            if with_bias else None)
    w = _cos_weights((b, h, sq, d))

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, None if bias is None else jnp.asarray(bias),
                                  causal=causal, block_q=128, block_k=128)
        return jnp.sum(out * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))

    tq, tk, tv = (T(x).requires_grad_() for x in (q, k, v))
    tbias = None if bias is None else T(bias)
    o, lse = tfa.flash_attention(tq, tk, tv, tbias, causal=causal)
    (o * T(w)).sum().backward()
    twin = tfa.flash_attention_bwd(T(q), T(k), T(v), tbias, o.detach(), lse, T(w),
                                   causal=causal)
    for name, g_auto, g_twin, g_jax in zip("qkv", (tq.grad, tk.grad, tv.grad), twin, want):
        np.testing.assert_allclose(g_auto.numpy(), np.asarray(g_jax), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")
        torch.testing.assert_close(g_twin, g_auto, rtol=0, atol=0)


def test_flash_autograd_gives_the_bias_no_gradient():
    rng = np.random.default_rng(1)
    q, k, v = (T(rng.normal(size=(1, 1, 40, 64)).astype(np.float32)).requires_grad_()
               for _ in range(3))
    bias = T(rng.normal(size=(1, 1, 40, 40)).astype(np.float32)).requires_grad_()
    tfa.flash_attention(q, k, v, bias)[0].sum().backward()
    assert bias.grad is None and q.grad is not None


def test_groupnorm_silu_grads_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 64)).astype(np.float32) * 2 + 0.5
    scale, bias = (rng.normal(size=(64,)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=x.shape).astype(np.float32)
    want_y, vjp = jax.vjp(lambda a, s, c: j_groupnorm_silu_ref(a, s, c, 8, 1e-5),
                          *(jnp.asarray(t) for t in (x, scale, bias)))
    want = vjp(jnp.asarray(g))
    tx, ts, tb = (T(t).requires_grad_() for t in (x, scale, bias))
    y = tgn.groupnorm_silu(tx, ts, tb, 8, 1e-5)
    y.backward(T(g))
    _close(y, want_y, 1e-5, "y")
    for name, got, w in zip(("x", "scale", "bias"), (tx.grad, ts.grad, tb.grad), want):
        _close(got, w, 1e-5, name)


# ---------------------------------------------------------------------------
# schedule, VAE encoder, losses
# ---------------------------------------------------------------------------
def test_ddpm_schedule_matches_jax():
    rng = np.random.default_rng(3)
    x0, eps = (rng.normal(size=(4, 8, 8, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 17, 500, 999])
    js, ts = JDDPM(), DDPMSchedule()
    _close(ts.add_noise(T(x0), T(eps), T(t)), js.add_noise(x0, eps, jnp.asarray(t)), 1e-5)
    _close(ts.velocity(T(x0), T(eps), T(t)), js.velocity(x0, eps, jnp.asarray(t)), 1e-5)


@pytest.fixture(scope="module")
def stacks():
    """(JAX pipeline modules, port pipeline modules) of the tiny configs with
    the same weights; the port's VAE carries the encoder too."""
    jpipe, tpipe = tiny_pipelines()
    jm, tm = jpipe.m, tpipe.m
    tm.vae.load_state_dict(from_jax.to_tensors(from_jax.vae(jm.vae_params, jm.vae.config)))
    return jm, tm


def test_vae_encoder_matches_jax(stacks):
    jm, tm = stacks
    rng = np.random.default_rng(4)
    pix = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    jmean, jlogvar = jm.vae.apply(jm.vae_params, jnp.asarray(pix), method=jm.vae.encode)
    with torch.no_grad():
        mean, logvar = tm.vae.encode(T(pix))
    _close(mean, jmean, 1e-5, "mean")
    _close(logvar, jlogvar, 1e-5, "logvar")
    eps = rng.normal(size=mean.shape).astype(np.float32)
    want = (np.asarray(jmean) + np.exp(0.5 * np.asarray(jlogvar)) * eps) * 0.13025
    _close(sample_latent(mean, logvar, T(eps), 0.13025), want, 1e-5, "latent")


def test_diffusion_loss_and_ip_mean_match_jax():
    rng = np.random.default_rng(5)
    pred, noise = (rng.normal(size=(3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    for m in (None, mask):
        want = jlosses.diffusion_loss(pred, noise, None if m is None else jnp.asarray(m))
        _close(tlosses.diffusion_loss(T(pred), T(noise), None if m is None else T(m)),
               want, 1e-5)
    b, s, i, v, d, dummy = 2, 2, 3, 4, 8, 2
    embeds = rng.normal(size=(b * s, dummy + i * v, d)).astype(np.float32)
    exists = rng.integers(0, 2, (b, i, s)).astype(np.float32)
    want = jlosses.mean_multiple_ip_embeds(embeds, exists, dummy, i, v, b)
    _close(tlosses.mean_multiple_ip_embeds(T(embeds), T(exists), dummy, i, v, b), want, 1e-5)


@pytest.mark.parametrize("kind", ["fast", "slow"])
def test_ip_contrastive_loss_and_grads_match_jax(kind):
    jfn = jlosses.ip_contrastive_loss if kind == "fast" else jlosses.ip_contrastive_loss_slow
    tfn = tlosses.ip_contrastive_loss if kind == "fast" else tlosses.ip_contrastive_loss_slow
    b, i, s, v, d = 2, 3, 2, 4, 8
    rng = np.random.default_rng(6)
    embeds = rng.normal(size=(b * s, i * v, d)).astype(np.float32)
    embeds[:, :v] = 0.0                      # one all-zero character block (trap C1)
    for exists in (np.ones((b, i, s), np.float32),
                   rng.integers(0, 2, (b, i, s)).astype(np.float32),
                   np.array([[[1, 0], [0, 1], [0, 0]]] * b, np.float32)):  # no positives
        want, jgrad = jax.value_and_grad(lambda e: jfn(e, jnp.asarray(exists), b, i, v))(
            jnp.asarray(embeds))
        te = T(embeds).requires_grad_()
        loss = tfn(te, T(exists), b, i, v)
        loss.backward()
        _close(loss, want, 1e-5, "loss")
        _close(te.grad, jgrad, 1e-5, "grad")
        assert torch.isfinite(te.grad).all()
    zero = torch.zeros((b * s, i * v, d), requires_grad=True)   # finite at all-zero
    tfn(zero, torch.ones((b, i, s)), b, i, v).backward()
    assert torch.isfinite(zero.grad).all()


# ---------------------------------------------------------------------------
# optimizer pieces
# ---------------------------------------------------------------------------
SCHEDULES = ["constant", "constant_with_warmup", "linear", "cosine", "cosine_with_min_lr",
             "cosine_with_restarts", "polynomial", "inverse_sqrt"]


@pytest.mark.parametrize("name", SCHEDULES)
def test_lr_schedules_match_jax(name):
    kw = dict(num_warmup_steps=10, num_training_steps=110, min_lr_ratio=0.1,
              num_cycles=2 if name == "cosine_with_restarts" else 0.5, power=2.0, lr_end=0.01)
    js = joptim.make_lr_schedule(name, 1.0, **kw)
    ts = toptim.make_lr_schedule(name, 1.0, **kw)
    steps = list(range(0, 131))
    np.testing.assert_allclose([ts(s) for s in steps], [float(js(s)) for s in steps],
                               rtol=0, atol=1e-7, err_msg=name)
    with pytest.raises(ValueError):
        toptim.make_lr_schedule("reduce_on_plateau", 1.0)


@pytest.fixture(scope="module")
def lora_stacks():
    """``stacks`` with UNet adapters of rank 4 on both sides."""
    jpipe, tpipe = tiny_pipelines(lora_rank=4)
    return jpipe.m, tpipe.m


@pytest.mark.parametrize("mode", ["full", "new", "ip", "lora"])
def test_unet_trainable_mask_selects_the_jax_set(request, mode):
    jm, tm = request.getfixturevalue("lora_stacks" if mode == "lora" else "stacks")
    jmask = jax.tree.leaves(joptim.unet_trainable_mask(jm.unet_params, mode))
    names = port_names(jm.unet_params, lambda t: from_jax.sdxl_unet(t, jm.unet.config))
    want = {name for name, i in names.items() if jmask[i]}
    tmask = toptim.unet_trainable_mask(tm.unet, mode)
    assert {n for n, keep in tmask.items() if keep} == want
    assert toptim.count_params(dict(tm.unet.named_parameters()), tmask) == \
        joptim.count_params(jm.unet_params, joptim.unet_trainable_mask(jm.unet_params, mode))


def test_unet_trainable_mask_rejects_an_unknown_mode(stacks):
    with pytest.raises(ValueError):
        toptim.unet_trainable_mask(stacks[1].unet, "everything")


def test_optimizer_matches_optax_on_the_same_gradients():
    """Clip by global norm, AdamW with decoupled decay and bias correction,
    the schedule stepped per update: three updates against optax."""
    rng = np.random.default_rng(7)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * scale for s in shapes]
             for scale in (3.0, 0.01, 1.0)]           # clipped, then not
    kw = dict(num_warmup_steps=2, num_training_steps=10, min_lr_ratio=0.1)
    tx = joptim.make_optimizer(joptim.make_lr_schedule("cosine_with_min_lr", 1e-2, **kw),
                               weight_decay=0.01, max_grad_norm=1.0)
    jp, state = [jnp.asarray(p) for p in params], None
    state = tx.init(jp)
    tp = [T(p).requires_grad_() for p in params]
    opt = toptim.make_optimizer(tp, toptim.make_lr_schedule("cosine_with_min_lr", 1e-2, **kw),
                                weight_decay=0.01, max_grad_norm=1.0)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, x in zip(tp, g):
            p.grad = T(x)
        assert opt.step()
        for got, want in zip(tp, jp):      # within an ulp or two of the parameter
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# train steps against JAX
# ---------------------------------------------------------------------------
def _stage2_batch(manga, b=2, hw=32, sources=2):
    """``tests/test_train.py``'s batch, as numpy."""
    rng = np.random.default_rng(3)
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
    }


STAGE1_KEYS = ("pixel_values", "text_input_ids", "text_input_ids_2", "original_size",
               "crop_coords_top_left", "target_size")


def _jax_draws(jm, batch, rng):
    """The draws of the JAX step's ``loss_fn`` for ``rng``, as numpy."""
    mean, _ = jm.vae.apply(jm.vae_params, jnp.asarray(batch["pixel_values"]),
                           method=jm.vae.encode)
    rng_n, rng_t = jax.random.split(jax.random.fold_in(rng, 1))
    b = mean.shape[0]
    return dict(latent_noise=np.asarray(jax.random.normal(jax.random.fold_in(rng, 0),
                                                          mean.shape, mean.dtype)),
                noise=np.asarray(jax.random.normal(rng_n, mean.shape, mean.dtype)),
                timesteps=np.asarray(jax.random.randint(rng_t, (b,), 0, 1000)))


def _frozen(jm, tm):
    kw = dict(vae_scaling=jm.vae.config.scaling_factor)
    j = jdiff.FrozenDiffusionStack(
        vae=jm.vae, vae_params=jm.vae_params, text_encoder=jm.text_encoder,
        text_encoder_params=jm.text_encoder_params, text_encoder_2=jm.text_encoder_2,
        text_encoder_2_params=jm.text_encoder_2_params, image_encoder=jm.image_encoder,
        image_encoder_params=jm.image_encoder_params, magi_encoder=jm.magi_encoder,
        magi_encoder_params=jm.magi_encoder_params, **kw)
    t = tdiff.FrozenDiffusionStack(vae=tm.vae, text_encoder=tm.text_encoder,
                                   text_encoder_2=tm.text_encoder_2,
                                   image_encoder=tm.image_encoder,
                                   magi_encoder=tm.magi_encoder, **kw)
    return j, t


def _port_trainables(unet, resampler, mode):
    """Fresh copies of the port's modules and their trainables by name."""
    unet = copy.deepcopy(unet)
    trainable, _ = toptim.partition_params(unet, toptim.unet_trainable_mask(unet, mode))
    params = {f"unet.{k}": p for k, p in trainable.items()}
    if resampler is not None:
        resampler = copy.deepcopy(resampler)
        trainable, _ = toptim.partition_params(
            resampler, {k: True for k, _ in resampler.named_parameters()})
        params.update({f"resampler.{k}": p for k, p in trainable.items()})
    return unet, resampler, params


def _jax_by_port_name(jm, tree, resampler_names):
    """A JAX ``{"unet": ..., "resampler": ...}`` tree as ``{port name: array}``
    (``resampler_names``: ``from_jax``'s converter of the resampler tree)."""
    out = {f"unet.{k}": v for k, v in from_jax.sdxl_unet(tree["unet"], jm.unet.config).items()}
    if "resampler" in tree:
        out.update({f"resampler.{k}": v for k, v in
                    resampler_names(tree["resampler"]).items()})
    return out


def _linear_projections(jm, tm):
    """(JAX ``ImageProjDummyModel``, its random weights, the port's with the
    same weights) at the tiny stack's widths."""
    manga = tm.manga
    kw = dict(cross_attention_dim=tm.unet.config.cross_attention_dim,
              num_tokens=manga.num_vision_tokens, num_dummy_tokens=manga.num_dummy_tokens)
    clip_dim = tm.image_encoder.config.hidden_size
    magi_dim = tm.magi_encoder.config.hidden_size
    jproj = JImageProjDummyModel(**kw)
    params = random_tree(jproj, jnp.zeros((1, manga.max_num_ips, clip_dim)),
                         jnp.zeros((1, manga.max_num_ips, magi_dim)), seed=6)
    tproj = TImageProjDummyModel(clip_dim, magi_dim, **kw)
    tproj.load_state_dict(from_jax.to_tensors(from_jax.image_proj(params)))
    return jproj, params, tproj


def _check_step(jm, tm, stage, mode, contrastive=None, ip_adapter_plus=True):
    """One JAX step and one port step on the same weights, batch and draws:
    loss, every trainable's gradient, the parameters after one AdamW update;
    the frozen parameters of the port bit-equal. ``ip_adapter_plus=False``
    trains an ``ImageProjDummyModel`` in place of the Resampler."""
    manga = tm.manga
    if ip_adapter_plus:
        jres, jres_params, tres = jm.resampler, jm.resampler_params, tm.resampler
        res_names = lambda tree: from_jax.resampler(tree, jm.resampler.config.depth)
    else:
        (jres, jres_params, tres), res_names = _linear_projections(jm, tm), from_jax.image_proj
    batch = _stage2_batch(manga)
    if stage == 1:
        batch = {k: batch[k] for k in STAGE1_KEYS}
    rng = jax.random.key(1)
    draws = {k: T(v) for k, v in _jax_draws(jm, batch, rng).items()}
    jfrozen, tfrozen = _frozen(jm, tm)

    # JAX: gradients over the whole tree, the optimizer masked to the trainables
    jparams = {"unet": jm.unet_params}
    mask = {"unet": joptim.unet_trainable_mask(jm.unet_params, mode)}
    if stage == 1:      # the stage-1 step takes the UNet tree itself
        jparams, mask = jm.unet_params, mask["unet"]
        jstep = jdiff.make_stage1_step(jm.unet, JDDPM())
    else:
        jparams["resampler"] = jres_params
        mask["resampler"] = jax.tree.map(lambda _: True, jres_params)
        jstep = jdiff.make_stage2_step(jm.unet, jres, JDDPM(), jdiff.Stage2Config(
            manga=manga, ip_contrastive=contrastive, ip_adapter_plus=ip_adapter_plus))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jfrozen, jbatch, rng), has_aux=True))(jparams)
    tx = joptim.make_optimizer(1e-4, weight_decay=1e-2, max_grad_norm=1.0,
                               trainable_mask=mask)
    jnew = jdiff.TrainState.create(jparams, tx).apply_gradients(jgrads).params
    if stage == 1:
        jgrads, jnew = {"unet": jgrads}, {"unet": jnew}

    # port
    unet, resampler, params = _port_trainables(tm.unet, None if stage == 1 else tres, mode)
    frozen_before = {k: p.detach().clone() for k, p in unet.named_parameters()
                     if not p.requires_grad}
    if stage == 1:
        tstep = tdiff.make_stage1_step(unet, DDPMSchedule())
    else:
        tstep = tdiff.make_stage2_step(unet, resampler, DDPMSchedule(), tdiff.Stage2Config(
            manga=manga, ip_contrastive=contrastive, ip_adapter_plus=ip_adapter_plus))
    loss, _ = tstep.loss_fn(tfrozen, {k: T(v) for k, v in batch.items()}, **draws)
    loss.backward()
    _close(loss, jloss, 5e-4, "loss")
    want_grads = _jax_by_port_name(jm, jgrads, res_names)
    want_new = _jax_by_port_name(jm, jnew, res_names)
    for name, p in params.items():     # no gradient: unused here (stage 1's IP weights)
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(grad, want_grads[name], 5e-4, f"grad {name}")
    opt = toptim.make_optimizer(params.values(), 1e-4, weight_decay=1e-2, max_grad_norm=1.0)
    assert opt.step()
    for name, p in params.items():
        _close(p, want_new[name], 5e-4, f"updated {name}")
    for name, p in unet.named_parameters():
        if name in frozen_before:
            assert torch.equal(p, frozen_before[name]), f"frozen {name} moved"
    return params


def test_stage2_step_matches_jax(stacks):
    params = _check_step(*stacks, stage=2, mode="new", contrastive="fast")
    assert any(k.startswith("resampler.") for k in params)
    assert any("dialog" in k for k in params) and any("_ip" in k for k in params)


def test_stage2_step_with_the_linear_projection_matches_jax(stacks):
    """``ip_adapter_plus=False``: the pooled CLIP-H CLS and the Magi CLS,
    regrouped sources-major, through ``ImageProjDummyModel``."""
    params = _check_step(*stacks, stage=2, mode="new", contrastive="fast",
                         ip_adapter_plus=False)
    assert {k for k in params if k.startswith("resampler.")} == {
        f"resampler.{n}" for n in ("proj.weight", "proj.bias", "proj_magi.weight",
                                   "proj_magi.bias", "norm.weight", "norm.bias",
                                   "dummy_tokens")}


def test_stage1_step_matches_jax(stacks):
    _check_step(*stacks, stage=1, mode="full")


def _port_grads(unet, resampler, params, frozen, batch, draws, remat=False):
    unet.remat = remat
    step = tdiff.make_stage2_step(unet, resampler, DDPMSchedule(),
                                  tdiff.Stage2Config(manga=unet.config.manga,
                                                     ip_contrastive="fast"))
    loss, _ = step.loss_fn(frozen, batch, **draws)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in params.items()}
    for p in params.values():
        p.grad = None
    return loss.detach(), grads


def test_partitioned_full_gradient_and_remat_forms_give_the_same_step(stacks):
    """``partition_params`` (frozen weights get no gradient) against every
    UNet weight taking a gradient with the optimizer holding only the
    trainables (the JAX full-mask form), and per-block remat against none:
    the same gradients, and the same update."""
    jm, tm = stacks
    batch = {k: T(v) for k, v in _stage2_batch(tm.manga).items()}
    draws = {k: T(v) for k, v in _jax_draws(jm, _stage2_batch(tm.manga),
                                            jax.random.key(1)).items()}
    _, tfrozen = _frozen(jm, tm)
    unet, resampler, params = _port_trainables(tm.unet, tm.resampler, "new")
    loss, grads = _port_grads(unet, resampler, params, tfrozen, batch, draws)
    loss_r, grads_r = _port_grads(unet, resampler, params, tfrozen, batch, draws, remat=True)
    unet.requires_grad_(True)
    loss_f, grads_f = _port_grads(unet, resampler, params, tfrozen, batch, draws)
    for other_loss, other in ((loss_r, grads_r), (loss_f, grads_f)):
        torch.testing.assert_close(other_loss, loss, rtol=0, atol=0)
        for k in grads:
            torch.testing.assert_close(other[k], grads[k], rtol=1e-6, atol=1e-9)


def test_accumulation_of_two_micro_steps_equals_the_mean_gradient_step(stacks):
    """``optax.MultiSteps`` semantics: the first micro-step leaves the
    parameters as they are, the second updates once with the mean of the two
    gradients. A large eps makes AdamW's first update scale with the
    gradient, so a sum or a single micro-gradient would show."""
    jm, tm = stacks
    batches = [_stage2_batch(tm.manga), _stage2_batch(tm.manga)]
    batches[1] = {k: v[::-1].copy() for k, v in batches[1].items()}
    draws = [{k: T(v) for k, v in _jax_draws(jm, b, jax.random.key(11 + n)).items()}
             for n, b in enumerate(batches)]
    _, tfrozen = _frozen(jm, tm)
    unet, resampler, params = _port_trainables(tm.unet, tm.resampler, "new")
    before = {k: p.detach().clone() for k, p in params.items()}
    kw = dict(weight_decay=0.0, eps=1.0, max_grad_norm=None)

    grads = []
    for b, d in zip(batches, draws):
        grads.append(_port_grads(unet, resampler, params, tfrozen,
                                 {k: T(v) for k, v in b.items()}, d)[1])
    opt = toptim.make_optimizer(params.values(), 1e-2, **kw)
    for k, p in params.items():
        p.grad = (grads[0][k] + grads[1][k]) / 2
    opt.step()
    want = {k: p.detach().clone() for k, p in params.items()}

    with torch.no_grad():
        for k, p in params.items():
            p.copy_(before[k])
    opt = toptim.make_optimizer(params.values(), 1e-2, accumulate=2, **kw)
    step = tdiff.make_stage2_step(unet, resampler, DDPMSchedule(), tdiff.Stage2Config(
        manga=tm.manga, ip_contrastive="fast"))
    for n, (b, d) in enumerate(zip(batches, draws)):
        loss, _ = step.loss_fn(tfrozen, {k: T(v) for k, v in b.items()}, **d)
        loss.backward()
        updated = opt.step()
        assert updated == (n == 1)
        if n == 0:
            for k, p in params.items():
                assert torch.equal(p, before[k]), "an early update"
    for k, p in params.items():
        torch.testing.assert_close(p.detach(), want[k], rtol=0, atol=1e-7)
        assert not torch.equal(p, before[k]) or torch.equal(want[k], before[k])


# ---------------------------------------------------------------------------
# data and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_workers", [0, 2])
def test_bucket_dataset_batches_are_the_jax_bytes(num_workers):
    anns = mangazero_pages(np.random.default_rng(8))
    tok = lambda text: (np.arange(77) * 7 + len(text)) % 250
    kw = dict(max_num_ips=3, max_num_ip_sources=2, max_num_dialogs=2, batch_size=4,
              i_drop_rate=0.2, t_drop_rate=0.3)
    jds = jbd.MangaTrainSizeBucketDataset("", "", tok, config=jbd.BucketDatasetConfig(**kw),
                                          annotations=anns)
    tds = tbd.MangaTrainSizeBucketDataset("", "", tok, config=tbd.BucketDatasetConfig(**kw),
                                          annotations=anns)
    want = list(jds.batches(shuffle=True, seed=5, num_workers=num_workers))
    got = list(tds.batches(shuffle=True, seed=5, num_workers=num_workers))
    assert len(got) == len(want) == tds.num_batches() > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    skipped = list(tds.batches(shuffle=True, seed=5, skip=2))
    for g, w in zip(skipped, got[2:]):
        assert all(np.array_equal(g[k], w[k]) for k in w)


def test_checkpoints_rotate_restore_and_export(tmp_path):
    mgr = CheckpointManager(os.fspath(tmp_path / "ckpt"), total_limit=2)
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((2,), float(step))}, torch.tensor([step], dtype=torch.uint8))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step-2", "step-3"]
    state, gen, step = mgr.restore()
    assert step == 3 and torch.equal(state["w"], torch.full((2,), 3.0)) and gen.item() == 3
    assert torch.equal(mgr.restore(2)[0]["w"], torch.full((2,), 2.0))
    weights = {"a": torch.arange(3.0), "b": torch.ones(2, 2)}
    export_weights(os.fspath(tmp_path / "w.pt"), weights)
    loaded = load_weights(os.fspath(tmp_path / "w.pt"))
    assert loaded.keys() == weights.keys() and all(torch.equal(loaded[k], weights[k])
                                                   for k in weights)


def test_runner_checkpoints_and_stops_on_sigterm(tmp_path):
    """The SIGTERM handler the loop installs ends it after the current step
    with a checkpoint of that step (the handler is called as the signal
    would call it)."""
    w = torch.nn.Parameter(torch.zeros(3))
    state = tdiff.TrainState({"w": w}, toptim.make_optimizer([w], 0.1))

    def step_fn(state, frozen, batch, generator):
        w.grad = torch.ones(3)
        state.apply_gradients()
        return {"loss": torch.tensor(1.0)}

    def on_step(step, metrics):
        if step == 2:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    before = signal.getsignal(signal.SIGTERM)
    cfg = RunConfig(max_train_steps=10, log_dir=os.fspath(tmp_path), checkpoint_every=100)
    run_training(step_fn, state, lambda start: iter([{}] * 10), cfg, device="cpu",
                 on_step=on_step)
    assert state.step == 2 and os.path.isdir(tmp_path / "step-2")
    assert signal.getsignal(signal.SIGTERM) == before      # the handler is put back


def test_prefetch_loader_runs_its_epochs_and_raises_a_producer_error():
    seen = []

    def epoch(e):
        seen.append(e)
        yield {"x": np.full((2,), e, np.float32)}
        if e == 4:
            raise RuntimeError("bad page")

    got = [b["x"][0].item() for b in PrefetchLoader(epoch, device="cpu", num_epochs=2,
                                                    first_epoch=1)]
    assert got == [1.0, 2.0] and seen == [1, 2]
    stream = iter(PrefetchLoader(epoch, device="cpu", first_epoch=4))
    assert isinstance(next(stream)["x"], torch.Tensor)
    with pytest.raises(RuntimeError, match="bad page"):
        next(stream)


def _write_run(tmp_path, **trainer):
    root = tmp_path / "data"
    root.mkdir()
    anns = mangazero_pages(np.random.default_rng(9))
    for ann in anns:
        ann.pop("image").save(root / ann["image_path"])
    (root / "annotations.json").write_text(json.dumps(anns))
    trainer = {"max_train_steps": 2, "log_every": 1, "checkpoint_every": 2, "seed": 0,
               **trainer}
    lines = "\n".join(f"  {k}: {v}" for k, v in trainer.items())
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
  batch_size: 4
  max_num_ip_sources: 2
  num_workers: 2
optimizer: {{lr: 1.0e-3, weight_decay: 0.01, max_grad_norm: 1.0}}
lr_scheduler: {{name: constant}}
trainer:
{lines}
""")
    return os.fspath(cfg)


def test_cli_trains_checkpoints_and_resumes_exactly(tmp_path):
    cfg = _write_run(tmp_path)
    run = lambda *a: cli.main(["--config", cfg, "--device", "cpu", *a])
    full = run("--log_dir", os.fspath(tmp_path / "full"), "--max_train_steps", "3")
    records = [json.loads(line) for line in
               (tmp_path / "full" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert os.path.isdir(tmp_path / "full" / "step-2") and os.path.isdir(tmp_path / "full" / "step-3")

    run("--log_dir", os.fspath(tmp_path / "cut"), "--max_train_steps", "1")
    resumed = run("--log_dir", os.fspath(tmp_path / "cut"), "--max_train_steps", "3", "--resume")
    assert resumed.step == full.step == 3
    for k, p in full.params.items():
        assert torch.equal(resumed.params[k], p), k


def test_cli_trains_stage1(tmp_path):
    cfg = _write_run(tmp_path, max_train_steps=1)
    with open(cfg) as f:
        text = f.read().replace("stage: condition", "stage: t2i").replace(
            "unet_trained_parameters: new", "unet_trained_parameters: full")
    with open(cfg, "w") as f:
        f.write(text)
    state = cli.main(["--config", cfg, "--device", "cpu", "--log_dir",
                      os.fspath(tmp_path / "logs")])
    assert state.step == 1 and all(k.startswith("unet.") for k in state.params)
    record = json.loads((tmp_path / "logs" / "metrics.jsonl").read_text())
    assert np.isfinite(record["loss"]) and "loss_ip_contrastive" not in record


@pytest.mark.parametrize("edit", [
    # a layout the JAX CLI does not know either (stage 3 under FSDP, once
    # refused here, trains: tests/test_torch_port_tensor_parallel.py)
    pytest.param((("trainer:\n", "trainer:\n  parallel: tp\n"), None, ValueError), id="edit1"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, edit):
    cfg = _write_run(tmp_path)
    with open(cfg) as f:
        text = f.read()
    *edits, error = edit
    for e in edits:
        text = text if e is None else text.replace(*e, 1)
    with open(cfg, "w") as f:
        f.write(text)
    with pytest.raises(error):
        cli.main(["--config", cfg, "--device", "cpu"])


def _with_policy(cfg, policy):
    with open(cfg) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace("remat: true", f"remat: true\n  remat_policy: {policy}", 1))
    return cfg


@pytest.fixture(scope="module")
def full_remat_step(tmp_path_factory):
    """One CLI step under full recompute (policy None)."""
    tmp = tmp_path_factory.mktemp("full_remat")
    return cli.main(["--config", _write_run(tmp, max_train_steps=1), "--device", "cpu",
                     "--log_dir", os.fspath(tmp / "logs")])


@pytest.mark.parametrize("policy", ["dots_attn", "dots_deepest", "dots", "attn"])
def test_cli_trains_under_each_remat_policy(tmp_path, full_remat_step, policy):
    """``model.remat_policy`` changes what the backward keeps, not a value:
    one CLI step's trainables equal full recompute's bit for bit."""
    cfg = _with_policy(_write_run(tmp_path, max_train_steps=1), policy)
    state = cli.main(["--config", cfg, "--device", "cpu", "--log_dir",
                      os.fspath(tmp_path / "logs")])
    assert state.step == full_remat_step.step == 1
    for name, p in full_remat_step.params.items():
        assert torch.equal(state.params[name], p), name


def test_cli_refuses_an_unknown_remat_policy(tmp_path):
    cfg = _with_policy(_write_run(tmp_path), "dots_everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        cli.main(["--config", cfg, "--device", "cpu"])


def test_cli_lora_needs_a_rank(tmp_path):
    """``unet_trained_parameters: lora`` without a positive ``model.lora_rank``
    would train only the IP projections: refused, as the JAX CLI does."""
    cfg = _write_run(tmp_path)
    with open(cfg) as f:
        text = f.read()
    for rank in ("", "\n  lora_rank: 0"):
        with open(cfg, "w") as f:
            f.write(text.replace("unet_trained_parameters: new",
                                 "unet_trained_parameters: lora" + rank))
        with pytest.raises(ValueError, match="lora_rank"):
            cli.main(["--config", cfg, "--device", "cpu"])
