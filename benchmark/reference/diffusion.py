"""The plain reference of the sampler, the conditioning of one served panel,
the stage-2 loss and the optimizer (torch and numpy only).

* Euler discrete at SDXL's "leading" spacing with ``steps_offset`` 1, CFG
  rows ``[uncond | cond]``, the uncond half with all-zero boxes.
* The stage-2 loss of DiffSensei (``scripts/train/train.py``): fp32 VAE
  encode and reparameterized sample, DDPM noising, frozen text, CLIP-H and
  Magi encoders, the Resampler, the sources' mean, the fast IP contrastive
  InfoNCE, the masked epsilon MSE.
* Global-norm clip, then AdamW with decoupled decay, written out.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import nets as N

BETA_START, BETA_END, TRAIN_STEPS = 0.00085, 0.012, 1000
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def alphas_cumprod():
    betas = np.linspace(BETA_START ** 0.5, BETA_END ** 0.5, TRAIN_STEPS, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def euler_tables(steps: int):
    """(timesteps [steps], sigmas [steps + 1], init_noise_sigma) as fp32 tensors."""
    acp = alphas_cumprod()
    full = np.sqrt((1.0 - acp) / acp)
    ratio = TRAIN_STEPS // steps
    t = ((np.arange(steps, dtype=np.float64) * ratio).round() + 1)[::-1].copy()
    sig = np.concatenate([np.interp(t, np.arange(TRAIN_STEPS), full), [0.0]])
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return f32(t), f32(sig), f32(np.sqrt(sig.max() ** 2 + 1.0))


def euler_step(lat, guided, sigma, sigma_next):
    x = lat.float()
    return x + (x - (x - sigma * guided)) / sigma * (sigma_next - sigma)


def clip_pixels(image, size: int = 224) -> np.ndarray:
    """CLIP's preprocessing: shortest side to 224 (bicubic), centre crop,
    mean/std normalization; NHWC float32."""
    from PIL import Image

    w, h = image.size
    if w == 0 or h == 0:
        return np.zeros((size, size, 3), np.float32)
    if w < h:
        nw, nh = size, max(1, int(round(h * size / w)))
    else:
        nw, nh = max(1, int(round(w * size / h))), size
    image = image.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - size) // 2, (nh - size) // 2
    arr = np.asarray(image.crop((left, top, left + size, top + size)).convert("RGB"),
                     np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def panel_conditioning(nets, stack, request, device) -> Dict:
    """What the denoise loop of one served request reads, for every one of its
    panels: text context and pooled embedding, IP tokens, per-level IP
    biases, dialog boxes and size ids, each ``[2, ...]`` (uncond, cond)."""
    from PIL import Image

    manga = stack["manga"]
    ids = {k: torch.as_tensor(np.asarray(v), dtype=torch.long, device=device)
           for k, v in request["prompt_ids"].items()}
    ctx, pooled = N.encode_prompt(nets, torch.cat([ids["neg_ids"], ids["ids"]]),
                                  torch.cat([ids["neg_ids_2"], ids["ids_2"]]))
    h, w = request["height"], request["width"]
    f = nets["vae"].factor
    lh, lw = h // f, w // f
    out = dict(ctx=ctx, pooled=pooled, ip_tokens=None, ip_biases=None)

    def cfg_rows(boxes, n):
        arr = np.zeros((2, n, 4), np.float32)
        if boxes:
            b = np.asarray(boxes, np.float32).reshape(-1, 4)[:n]
            arr[1, :len(b)] = b
        return torch.from_numpy(arr).to(device)

    chars = request["characters"]
    boxes = request["ip_bbox"][:manga["max_num_ips"]]
    if chars:
        imgs = [im.convert("RGB") for im in chars][:manga["max_num_ips"]]
        imgs += [Image.new("RGB", (224, 224), (0, 0, 0))] * (manga["max_num_ips"] - len(imgs))
        pixels = torch.from_numpy(np.stack([clip_pixels(im) for im in imgs])).to(device)
        clip_h, _ = nets["image_encoder"](pixels)
        _, magi = nets["magi_encoder"](pixels)
        valid = (torch.arange(pixels.shape[0], device=device) < min(len(boxes), len(imgs))).float()
        if len(boxes) < pixels.shape[0]:
            clip_h = clip_h * valid[:, None, None]
            magi = magi * valid[:, None]
        pos = nets["resampler"](clip_h[None], magi[None])
        neg = nets["resampler"](torch.zeros_like(clip_h[None]), torch.zeros_like(magi[None]))
        out["ip_tokens"] = torch.cat([neg, pos])
        ip_rows = cfg_rows(boxes, manga["max_num_ips"])
        out["ip_biases"] = {
            lv: N.ip_bias(ip_rows, *N.level_shape(lh, lw, lv), manga["num_vision_tokens"],
                          manga["num_dummy_tokens"])
            for lv in nets["unet"].levels()}
    out["dialog_bbox"] = cfg_rows(request["dialog_bbox"][:manga["max_num_dialogs"]],
                                  manga["max_num_dialogs"])
    out["time_ids"] = torch.tensor([[h, w, 0, 0, h, w]] * 2, dtype=torch.float32, device=device)
    return out


def unet_rows(nets, cond, lat_in, t, ip_scale):
    """The UNet's noise prediction on the panel's two rows (uncond, cond)."""
    return nets["unet"](lat_in, t.expand(2), cond["ctx"], cond["pooled"], cond["time_ids"],
                        cond["ip_tokens"], cond["ip_biases"], ip_scale, cond["dialog_bbox"]).float()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def add_noise(x0, noise, t):
    acp = torch.tensor(alphas_cumprod(), dtype=torch.float32, device=x0.device)[t.long()]
    a, b = acp.sqrt().reshape(-1, 1, 1, 1), (1 - acp).sqrt().reshape(-1, 1, 1, 1)
    return a * x0 + b * noise


def l2n(f):
    return f * torch.rsqrt(torch.clamp(f.square().sum(-1, keepdim=True), min=1e-12))


def contrastive_fast(blocks, exists, b, i, v, temperature=0.07):
    """InfoNCE over (sample, character) identities; views of one character
    from different sources are positives."""
    s = blocks.shape[0] // b
    d = blocks.shape[-1]
    f = l2n(blocks.reshape(b, s, i, v, d).permute(0, 2, 1, 3, 4).mean(dim=3))
    views = f.reshape(b * i * s, d).float()
    valid = exists.reshape(-1) > 0
    sim = views @ views.T / temperature
    n = sim.shape[0]
    ident = torch.arange(n // s, device=sim.device).repeat_interleave(s)
    eye = torch.eye(n, dtype=torch.bool, device=sim.device)
    pair = valid[:, None] & valid[None, :] & ~eye
    pos = (ident[:, None] == ident[None, :]) & pair
    neg = torch.full((), -1e9, device=sim.device)
    log_denom = torch.logsumexp(torch.where(pair, sim, neg), dim=1)
    per = -(torch.where(pos, sim, neg) - log_denom[:, None])
    npos = pos.sum(1)
    anchor = torch.where(pos, per, torch.zeros((), device=sim.device)).sum(1) / torch.clamp(npos, min=1)
    has = npos > 0
    return torch.where(has, anchor, torch.zeros((), device=sim.device)).sum() / torch.clamp(has.sum(), min=1)


def ip_tokens_from_sources(embeds, exists, dummy, i, v, b):
    """Each character's block averaged over its valid sources; characters
    with none zeroed; the dummy block of source 0."""
    d = embeds.shape[-1]
    s = embeds.shape[0] // b
    ip = embeds[:, dummy:].reshape(b, s, i, v, d).permute(0, 2, 1, 3, 4)
    mask = exists.to(ip.dtype)[..., None, None]
    mean = ((ip * mask).sum(2) / torch.clamp(mask.sum(2), min=1.0)).reshape(b, i * v, d)
    tokens = torch.cat([embeds.reshape(b, s, -1, d)[:, 0, :dummy], mean], dim=1)
    any_src = (exists.sum(-1) > 0).to(tokens.dtype).repeat_interleave(v, dim=1)
    keep = torch.cat([torch.ones((b, dummy), device=tokens.device, dtype=tokens.dtype), any_src], 1)
    return tokens * keep[..., None]


def lr_at(update: int, opt: Dict, sched: Dict, total: int) -> float:
    warm = sched["num_warmup_steps"]
    w = 1.0 if warm <= 0 else min(1.0, update / warm)
    prog = min(max((update - warm) / max(total - warm, 1), 0.0), 1.0)
    floor = sched.get("min_lr_ratio", 0.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return opt["lr"] * w * (floor + (1.0 - floor) * cos)


class AdamW:
    """Global-norm clip, then AdamW (decoupled decay, bias-corrected moments)."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: Dict):
        self.params, self.opt = params, opt
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def clipped(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads.values()]))
        cap = self.opt["max_grad_norm"]
        factor = 1.0 if norm < cap else cap / norm
        return {k: g * factor for k, g in grads.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        b1, b2 = self.opt["betas"]
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * self.opt["weight_decay"])
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(self.opt["eps"])
            p.addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** self.t))


def trainable_names(nets, mode: str) -> List[str]:
    """The stage's trainables: the UNet's IP projections and dialog embedding
    (``new``), and the whole Resampler."""
    if mode != "new":
        raise ValueError(f"the reference trains unet_trained_parameters 'new' only, got {mode!r}")
    names = [f"unet.{k}" for k, _ in nets["unet"].named_parameters()
             if "_ip" in k or "dialog" in k]
    return names + [f"resampler.{k}" for k, _ in nets["resampler"].named_parameters()]


def stage2_loss_and_grads(nets, stack, batch, generator, contrastive_weight: float,
                          trainables: Dict[str, torch.Tensor]):
    """One stage-2 loss and the trainables' gradients. Draws from
    ``generator`` in the program's order: the latent sample's noise, the
    diffusion noise, the timesteps, each for the whole batch. The UNet runs a
    row at a time with its gradient accumulated, which changes memory, not
    the arithmetic."""
    manga = stack["manga"]
    dummy, v = manga["num_dummy_tokens"], manga["num_vision_tokens"]
    unet, res = nets["unet"], nets["resampler"]
    b, i, s = batch["ip_exists"].shape
    with torch.no_grad():
        moments = [nets["vae"].encode(batch["pixel_values"][r:r + 1]) for r in range(b)]
        mean = torch.cat([m for m, _ in moments])
        logvar = torch.cat([lv for _, lv in moments])
        eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
        latents = (mean + torch.exp(0.5 * logvar) * eps) * stack["vae"]["scaling_factor"]
        noise = torch.randn(latents.shape, generator=generator, device=latents.device,
                            dtype=latents.dtype)
        t = torch.randint(0, TRAIN_STEPS, (b,), generator=generator, device=latents.device)
        noisy = add_noise(latents, noise, t)
        crops = batch["ip_pixel_values"].reshape((b * i * s,) + tuple(batch["ip_pixel_values"].shape[3:]))
        magi_crops = batch["magi_pixel_values"].reshape((b * i * s,) + tuple(batch["magi_pixel_values"].shape[3:]))
        clip_h, _ = nets["image_encoder"](crops)
        _, magi = nets["magi_encoder"](magi_crops)
        ctx, pooled = N.encode_prompt(nets, batch["text_input_ids"].long(),
                                      batch["text_input_ids_2"].long())
    magi = magi.reshape(b, i, s, -1).transpose(1, 2).reshape(b * s, i, -1)
    p, dc = clip_h.shape[-2:]
    clip_h = clip_h.reshape(b, i, s, p, dc).transpose(1, 2).reshape(b * s, i, p, dc)
    embeds = res(clip_h, magi)
    exists = batch["ip_exists"]
    loss_c = contrastive_fast(embeds[:, dummy:], exists, b, i, v)
    tokens = ip_tokens_from_sources(embeds, exists, dummy, i, v, b)
    leaf = tokens.detach().requires_grad_(True)
    lh, lw = latents.shape[1:3]
    time_ids = torch.cat([batch["original_size"], batch["crop_coords_top_left"],
                          batch["target_size"]], dim=-1).float()
    mask = batch.get("sample_mask")
    m = torch.ones(b, device=latents.device) if mask is None else mask.float()
    denom = torch.clamp(m.sum(), min=1.0)
    loss_d = torch.zeros((), device=latents.device)
    for r in range(b):
        biases = {lv: N.ip_bias(batch["ip_bbox"][r:r + 1], *N.level_shape(lh, lw, lv), v, dummy)
                  for lv in unet.levels()}
        pred = unet(noisy[r:r + 1], t[r:r + 1].float(), ctx[r:r + 1], pooled[r:r + 1],
                    time_ids[r:r + 1], leaf[r:r + 1], biases, 1.0, batch["dialog_bbox"][r:r + 1])
        part = (pred.float() - noise[r:r + 1]).square().mean() * m[r] / denom
        part.backward()
        loss_d = loss_d + part.detach()
    torch.autograd.backward([tokens, contrastive_weight * loss_c],
                            [leaf.grad, torch.ones((), device=loss_c.device)])
    grads = {k: (p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p))
             for k, p in trainables.items()}
    for p in trainables.values():
        p.grad = None
    return (loss_d + contrastive_weight * loss_c.detach()).item(), grads
