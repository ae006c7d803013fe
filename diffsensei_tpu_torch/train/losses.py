"""Training losses for the three-stage DiffSensei recipe (port of
``diffsensei_tpu/train/losses.py``).

* ``diffusion_loss``: epsilon-prediction MSE, with a per-sample mask for padded
  bucket batches.
* ``mean_multiple_ip_embeds``: each character's token block averaged over its
  valid source crops.
* ``ip_contrastive_loss`` (``fast``) and ``ip_contrastive_loss_slow``: the
  InfoNCE over (sample, character) identities that the JAX package
  reconstructed for the reference's missing ``compute_ip_contrastive_loss``;
  views of one character from different source crops are positives.

The math follows the JAX functions op for op, dtypes included.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_LOGIT = -1e9


def _safe_l2_normalize(f: torch.Tensor) -> torch.Tensor:
    """``f * rsqrt(max(sumsq, 1e-12))`` along the last axis: the floor sits
    inside the square root, so the gradient is finite at ``f == 0`` (ROADMAP
    trap C1; ``F.normalize`` floors the norm, not its square)."""
    sumsq = f.square().sum(dim=-1, keepdim=True)
    return f * torch.rsqrt(torch.clamp(sumsq, min=1e-12))


def diffusion_loss(noise_pred: torch.Tensor, noise: torch.Tensor,
                   sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Epsilon MSE in fp32; ``sample_mask [B]`` drops padded batch rows."""
    err = (noise_pred.float() - noise.float()).square()
    if sample_mask is None:
        return err.mean()
    per_sample = err.mean(dim=tuple(range(1, err.dim())))
    m = sample_mask.float()
    return (per_sample * m).sum() / torch.clamp(m.sum(), min=1.0)


def mean_multiple_ip_embeds(image_embeds: torch.Tensor, ip_exists: torch.Tensor,
                            num_dummy_tokens: int, max_num_ips: int,
                            num_vision_tokens: int, bsz: int) -> torch.Tensor:
    """``[bsz * S, dummy + I*V, D]`` (sources-major) and ``ip_exists [bsz, I, S]``
    -> ``[bsz, dummy + I*V, D]``: the dummy block of source 0, each character
    block averaged over its valid sources (sum / max(count, 1))."""
    d = image_embeds.shape[-1]
    n_sources = image_embeds.shape[0] // bsz
    ip = image_embeds[:, num_dummy_tokens:, :]
    ip = ip.reshape(bsz, n_sources, max_num_ips, num_vision_tokens, d)
    ip = ip.permute(0, 2, 1, 3, 4)                          # [B, I, S, V, D]
    mask = ip_exists.to(ip.dtype)[..., None, None]          # [B, I, S, 1, 1]
    summed = (ip * mask).sum(dim=2)                         # [B, I, V, D]
    count = torch.clamp(mask.sum(dim=2), min=1.0)
    mean = (summed / count).reshape(bsz, max_num_ips * num_vision_tokens, d)
    first_source = image_embeds.reshape(bsz, n_sources, -1, d)[:, 0]
    return torch.cat([first_source[:, :num_dummy_tokens], mean], dim=1)


def _char_features(ip_embeds: torch.Tensor, bsz: int, max_num_ips: int,
                   num_vision_tokens: int) -> torch.Tensor:
    """``[bsz*S, I*V, D]`` -> L2-normalized ``[bsz, I, S, D]`` (tokens mean-pooled)."""
    d = ip_embeds.shape[-1]
    n_sources = ip_embeds.shape[0] // bsz
    f = ip_embeds.reshape(bsz, n_sources, max_num_ips, num_vision_tokens, d)
    f = f.permute(0, 2, 1, 3, 4).mean(dim=3)                # [B, I, S, D]
    return _safe_l2_normalize(f)


def _info_nce(sim: torch.Tensor, valid: torch.Tensor, n_sources: int) -> torch.Tensor:
    """Multi-positive InfoNCE over ``sim [N, N]``: views of one identity
    (consecutive runs of ``n_sources``) are positives, self and invalid views
    are left out; 0.0 when no anchor has a positive."""
    n = sim.shape[0]
    ident = torch.arange(n // n_sources, device=sim.device).repeat_interleave(n_sources)
    same_class = ident[:, None] == ident[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=sim.device)
    pair_valid = valid[:, None] & valid[None, :] & ~eye
    pos_mask = same_class & pair_valid
    neg = torch.full((), NEG_LOGIT, dtype=sim.dtype, device=sim.device)
    log_denom = torch.logsumexp(torch.where(pair_valid, sim, neg), dim=1)
    per_pos = -(torch.where(pos_mask, sim, neg) - log_denom[:, None])
    n_pos = pos_mask.sum(dim=1)
    zero = torch.zeros((), dtype=sim.dtype, device=sim.device)
    anchor_loss = torch.where(pos_mask, per_pos, zero).sum(dim=1) / torch.clamp(n_pos, min=1)
    has_pos = n_pos > 0
    total = torch.where(has_pos, anchor_loss, zero).sum()
    return total / torch.clamp(has_pos.sum(), min=1)


def ip_contrastive_loss(ip_embeds: torch.Tensor, ip_exists: torch.Tensor, bsz: int,
                        max_num_ips: int, num_vision_tokens: int,
                        temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE over (sample, character) identities across source views.

    ``ip_embeds [bsz * S, I * V, D]`` is the resampler output without the
    dummy block; ``ip_exists [bsz, I, S]``. Returns an fp32 scalar."""
    f = _char_features(ip_embeds, bsz, max_num_ips, num_vision_tokens)
    b, i, s, d = f.shape
    views = f.reshape(b * i * s, d).float()
    valid = ip_exists.reshape(b * i * s) > 0
    return _info_nce(views @ views.T / temperature, valid, s)


def ip_contrastive_loss_slow(ip_embeds: torch.Tensor, ip_exists: torch.Tensor, bsz: int,
                             max_num_ips: int, num_vision_tokens: int,
                             temperature: float = 0.07) -> torch.Tensor:
    """Token-level variant: tokens normalized before pooling, so the
    similarity of two views is the mean of their token-pair similarities;
    then the same InfoNCE."""
    d = ip_embeds.shape[-1]
    n_sources = ip_embeds.shape[0] // bsz
    f = ip_embeds.reshape(bsz, n_sources, max_num_ips, num_vision_tokens, d)
    f = _safe_l2_normalize(f.permute(0, 2, 1, 3, 4))       # [B, I, S, V, D]
    n = bsz * max_num_ips * n_sources
    pooled = f.reshape(n, num_vision_tokens, d).float().mean(dim=1)
    valid = ip_exists.reshape(n) > 0
    return _info_nce(pooled @ pooled.T / temperature, valid, n_sources)
