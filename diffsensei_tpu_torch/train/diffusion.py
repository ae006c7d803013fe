"""Diffusion training steps: stage 1 (t2i) and stage 2 (condition) (port of
``diffsensei_tpu/train/diffusion.py``).

* stage 1: the SDXL epsilon-MSE fine-tune on manga panels
  (``scripts/train/train_t2i.py:258-303`` in the reference);
* stage 2: adds the IP machinery: frozen CLIP-H and Magi character encoders,
  the trainable Resampler (or, with ``ip_adapter_plus=False``, the linear
  ``ImageProjDummyModel``), the source mean, the optional contrastive loss, and
  the manga UNet with the masked-IP biases and the dialog embedding
  (``scripts/train/train.py:336-426``).

The trainable parameters are the ``requires_grad`` ones of the UNet (and the
Resampler), split by ``optim.partition_params`` and held in fp32; the frozen
encoders run under ``torch.no_grad`` in ``FrozenDiffusionStack``. A step is
``step(state, frozen, batch, generator) -> metrics``: it runs ``loss_fn``,
the backward and one optimizer call, and updates ``state`` in place (the JAX
step returns a new state). ``loss_fn`` draws the latent-sample noise, the
diffusion noise and the timesteps from ``generator`` in that order, or takes
them as tensors (the tests feed it the JAX draws).

Data parallelism (``group``, the ranks' process group): a rank's batch holds
rows ``[rank::world]`` of the global batch. Every draw is made for the global
batch and the rank takes its rows (given draws are the global ones too), the
diffusion loss is scaled by ``parallel.train.rank_weight`` and the contrastive
loss sees the global batch (``parallel.train.gather_rows``), so that the
averaged gradient is the single-process step's on the global batch; the
step's metrics are the ranks' means. Under DDP or FSDP the CLI runs the
forward through the wrapper (``step.forward``) and averages the gradients of
the parameters FSDP keeps whole (``step.sync_grads``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from diffsensei_tpu_torch.core.config import MangaConfig
from diffsensei_tpu_torch.models.schedulers import DDPMSchedule
from diffsensei_tpu_torch.models.unet import attention_levels, level_spatial_shape
from diffsensei_tpu_torch.models.vae import sample_latent
from diffsensei_tpu_torch.ops.masked_ip import build_ip_attention_bias
from diffsensei_tpu_torch.parallel.mesh import host_rows
from diffsensei_tpu_torch.parallel.train import (
    full_state, gather_rows, is_sharded, local_like, rank_weight, reduce_metrics)
from diffsensei_tpu_torch.train import losses
from diffsensei_tpu_torch.train.optim import Optimizer
from diffsensei_tpu_torch.utils.observability import span

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The trainables by name (``"unet.<name>"``, ``"resampler.<name>"``),
    their optimizer, and the count of step calls."""

    params: Dict[str, nn.Parameter]
    optimizer: Optimizer
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer call on the parameters' ``.grad`` (an update, or a
        micro-step of an accumulation)."""
        self.optimizer.step()
        self.step += 1

    def state_dict(self) -> Dict:
        """Whole tensors under their single-process names (sharded ones
        gathered: every rank must call it)."""
        return {"params": {k: full_state(p.detach()) if is_sharded(p) else p.detach().cpu()
                           for k, p in self.params.items()},
                "optimizer": full_state(self.optimizer.state_dict()), "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Load ``state_dict``'s whole tensors, each put back into its
        parameter's sharding."""
        if state["params"].keys() != self.params.keys():
            raise ValueError("checkpoint holds other trainable parameters than this run")
        for name, p in self.params.items():
            p.copy_(local_like(state["params"][name], p))
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


@dataclasses.dataclass
class FrozenDiffusionStack:
    """The frozen modules a train step runs without gradients."""

    vae: Optional[nn.Module] = None
    text_encoder: Optional[nn.Module] = None
    text_encoder_2: Optional[nn.Module] = None
    image_encoder: Optional[nn.Module] = None
    magi_encoder: Optional[nn.Module] = None
    vae_scaling: float = 0.13025


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    manga: MangaConfig
    ip_contrastive: Optional[str] = None        # None | "fast" | "slow"
    ip_contrastive_weight: float = 0.1
    # True: the Perceiver Resampler over patch features (released DiffSensei);
    # False: the linear ImageProjDummyModel over the pooled CLIP-H CLS
    # (models/projection.py; the reference's train.py:357-360)
    ip_adapter_plus: bool = True


def _encode_text(frozen: FrozenDiffusionStack, ids, ids_2):
    h1, _ = frozen.text_encoder(ids)
    h2, pooled = frozen.text_encoder_2(ids_2)
    return torch.cat([h1, h2], dim=-1), pooled


def _world(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _own_rows(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """This rank's rows of a global-batch draw."""
    return x if group is None else host_rows(x, dist.get_rank(group), _world(group))


def _draw(shape, like: torch.Tensor, generator: Optional[torch.Generator],
          given: Optional[torch.Tensor], group=None) -> torch.Tensor:
    if given is None:
        given = torch.randn((shape[0] * _world(group),) + tuple(shape[1:]),
                            generator=generator, device=like.device, dtype=like.dtype)
    return _own_rows(given, group).to(like.device, like.dtype)


def _encode_latents(frozen, pixel_values, generator, latent_noise, group=None):
    with span("train.vae_encode"):
        mean, logvar = frozen.vae.encode(pixel_values)
    eps = _draw(mean.shape, mean, generator, latent_noise, group)
    return sample_latent(mean, logvar, eps, frozen.vae_scaling)


def _noise_and_t(schedule: DDPMSchedule, latents, generator, noise, timesteps, group=None):
    noise = _draw(latents.shape, latents, generator, noise, group)
    if timesteps is None:
        timesteps = torch.randint(0, schedule.num_train_timesteps,
                                  (latents.shape[0] * _world(group),),
                                  generator=generator, device=latents.device)
    timesteps = _own_rows(timesteps, group).to(latents.device)
    return noise, timesteps, schedule.add_noise(latents, noise, timesteps)


def _panel_count(batch: Batch) -> torch.Tensor:
    """Real (non-padded) panels in the batch: the sum of the loss mask."""
    mask = batch.get("sample_mask")
    if mask is not None:
        return mask.sum()
    return torch.tensor(float(batch["pixel_values"].shape[0]),
                        device=batch["pixel_values"].device)


def _diffusion_loss(pred, noise, batch: Batch, group) -> torch.Tensor:
    """The masked epsilon MSE of the rank's rows, under ``group`` scaled to
    its share of the global masked mean."""
    loss = losses.diffusion_loss(pred, noise, batch.get("sample_mask"))
    return loss if group is None else loss * rank_weight(_panel_count(batch), group)


def _time_ids(batch: Batch) -> torch.Tensor:
    """SDXL micro-conditioning [orig_hw, crop_tl, target_hw]."""
    return torch.cat([batch["original_size"], batch["crop_coords_top_left"],
                      batch["target_size"]], dim=-1).float()


def _make_step(loss_fn: Callable, group: Optional[dist.ProcessGroup] = None) -> Callable:
    def step(state: TrainState, frozen: FrozenDiffusionStack, batch: Batch,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        with span("train.step", step=state.step):
            with span("train.forward"):
                loss, metrics = step.forward(frozen, batch, generator)
            with span("train.backward"):
                loss.backward()
                if step.sync_grads is not None:
                    step.sync_grads()
            with span("train.optimizer"):
                state.apply_gradients()
            with span("train.metrics"):
                return reduce_metrics({**{k: v.detach() for k, v in metrics.items()},
                                       "loss": loss.detach(), "panels": _panel_count(batch)},
                                      group)

    step.loss_fn = loss_fn   # exposed for equivalence tests and diagnostics
    step.forward = loss_fn   # DDP's wrapper under trainer.parallel: dp
    step.sync_grads = None   # the gradient average of FSDP's whole parameters
    return step


# ---------------------------------------------------------------------------
# stage 1: t2i fine-tune (train_t2i.py)
# ---------------------------------------------------------------------------
def make_stage1_step(unet: nn.Module, schedule: DDPMSchedule,
                     group: Optional[dist.ProcessGroup] = None) -> Callable:
    """``step(state, frozen, batch, generator) -> metrics``; trains whatever
    of ``unet`` requires a gradient; ``group``: the data-parallel ranks."""

    def loss_fn(frozen: FrozenDiffusionStack, batch: Batch,
                generator: Optional[torch.Generator] = None, *,
                latent_noise=None, noise=None, timesteps=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        with torch.no_grad(), span("train.encode"):
            latents = _encode_latents(frozen, batch["pixel_values"], generator, latent_noise,
                                      group)
            noise, t, noisy = _noise_and_t(schedule, latents, generator, noise, timesteps,
                                           group)
            ctx, pooled = _encode_text(frozen, batch["text_input_ids"],
                                       batch["text_input_ids_2"])
        with span("train.unet_forward"):
            pred = unet(noisy, t.float(), ctx, pooled, _time_ids(batch))
        loss = _diffusion_loss(pred, noise, batch, group)
        return loss, {"loss_diffusion": loss}

    return _make_step(loss_fn, group)


# ---------------------------------------------------------------------------
# stage 2: IP-conditioned training (train.py)
# ---------------------------------------------------------------------------
def make_stage2_step(unet: nn.Module, resampler: nn.Module, schedule: DDPMSchedule,
                     cfg: Stage2Config, group: Optional[dist.ProcessGroup] = None) -> Callable:
    """``step(state, frozen, batch, generator) -> metrics``.

    Expected batch (the bucket dataset's collate): pixel_values [B, H, W, 3];
    text_input_ids / _2 [B, 77]; ip_pixel_values and magi_pixel_values
    [B, I, S, 224, 224, 3]; ip_exists [B, I, S]; ip_bbox [B, I, 4];
    dialog_bbox [B, Dlg, 4]; original_size / crop_coords_top_left /
    target_size [B, 2]; optionally sample_mask [B].

    ``resampler`` is the Perceiver ``Resampler`` (``cfg.ip_adapter_plus``,
    over the CLIP-H patch features) or an ``ImageProjDummyModel`` (over the
    pooled CLIP-H CLS); both also take the Magi CLS. ``group``: the
    data-parallel ranks.
    """
    if cfg.ip_contrastive not in (None, "fast", "slow"):
        raise ValueError(f"ip_contrastive must be null, fast or slow, got {cfg.ip_contrastive!r}")
    manga = cfg.manga

    def loss_fn(frozen: FrozenDiffusionStack, batch: Batch,
                generator: Optional[torch.Generator] = None, *,
                latent_noise=None, noise=None, timesteps=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        b, i, s = batch["ip_exists"].shape
        with torch.no_grad(), span("train.encode"):
            latents = _encode_latents(frozen, batch["pixel_values"], generator, latent_noise,
                                      group)
            noise, t, noisy = _noise_and_t(schedule, latents, generator, noise, timesteps,
                                           group)
            # frozen character encoders over all B*I*S crops (train.py:356-367)
            crops = batch["ip_pixel_values"].reshape(
                (b * i * s,) + tuple(batch["ip_pixel_values"].shape[3:]))
            magi_crops = batch["magi_pixel_values"].reshape(
                (b * i * s,) + tuple(batch["magi_pixel_values"].shape[3:]))
            clip_h, clip_cls = frozen.image_encoder(crops)
            _, magi_cls = frozen.magi_encoder(magi_crops)
            ctx, pooled = _encode_text(frozen, batch["text_input_ids"],
                                       batch["text_input_ids_2"])
        # regroup [B, I, S, ...] -> sources-major [B*S, I, ...] (train.py:362)
        magi_cls = magi_cls.reshape(b, i, s, -1).transpose(1, 2).reshape(b * s, i, -1)
        if cfg.ip_adapter_plus:
            p, d_clip = clip_h.shape[-2:]
            clip_h = clip_h.reshape(b, i, s, p, d_clip).transpose(1, 2).reshape(
                b * s, i, p, d_clip)
            image_embeds = resampler(clip_h, magi_cls)
        else:
            clip_cls = clip_cls.reshape(b, i, s, -1).transpose(1, 2).reshape(b * s, i, -1)
            image_embeds = resampler(clip_cls, magi_cls)

        # contrastive loss on the character blocks (train.py:372-377)
        if cfg.ip_contrastive is None:
            loss_c = torch.zeros((), device=image_embeds.device)
        else:
            contrastive = (losses.ip_contrastive_loss if cfg.ip_contrastive == "fast"
                           else losses.ip_contrastive_loss_slow)
            blocks, exists = image_embeds[:, manga.num_dummy_tokens:, :], batch["ip_exists"]
            if group is not None:     # over the global batch, samples in its order
                blocks = gather_rows(blocks.reshape((b, s) + tuple(blocks.shape[1:])),
                                     group).flatten(0, 1)
                exists = gather_rows(exists, group)
            loss_c = contrastive(blocks, exists, exists.shape[0], i, manga.num_vision_tokens)

        # source mean (train.py:380), then characters without a source zeroed
        ip_tokens = losses.mean_multiple_ip_embeds(
            image_embeds, batch["ip_exists"], manga.num_dummy_tokens, i,
            manga.num_vision_tokens, b)
        any_source = (batch["ip_exists"].sum(dim=-1) > 0).to(ip_tokens.dtype)
        char_mask = any_source.repeat_interleave(manga.num_vision_tokens, dim=1)
        keep = torch.cat([torch.ones((b, manga.num_dummy_tokens), dtype=ip_tokens.dtype,
                                     device=ip_tokens.device), char_mask], dim=1)
        ip_tokens = ip_tokens * keep[..., None]

        # masked-IP biases per attention level, built once per step
        lh, lw = latents.shape[1], latents.shape[2]
        biases = {
            level: build_ip_attention_bias(
                batch["ip_bbox"], *level_spatial_shape(unet.config, lh, lw, level),
                manga.num_vision_tokens, manga.num_dummy_tokens)
            for level in attention_levels(unet.config)}

        with span("train.unet_forward"):
            pred = unet(noisy, t.float(), ctx, pooled, _time_ids(batch),
                        ip_hidden_states=ip_tokens, ip_attn_bias=biases, ip_scale=1.0,
                        dialog_bbox=batch["dialog_bbox"])
        loss_d = _diffusion_loss(pred, noise, batch, group)
        loss = loss_d + cfg.ip_contrastive_weight * loss_c
        return loss, {"loss_diffusion": loss_d, "loss_ip_contrastive": loss_c}

    return _make_step(loss_fn, group)
