"""Spatially masked IP-Adapter conditioning ops (port of
``diffsensei_tpu/ops/masked_ip.py``).

The semantics are the JAX package's, which are the reference's:

* the pixel grid is ``linspace(0, 1, w) x linspace(0, 1, h)``;
* a query may attend to character i's token block iff it lies inside
  character i's bbox, bounds inclusive;
* the dummy block is attendable only where no character bbox covers the pixel;
* key columns are laid out ``[dummy block | char 0 | ... | char I-1]``;
* masked entries get the additive bias -10000.0 (not -inf);
* dialog boxes use floor bounds, half-open ``[x1, x2) x [y1, y2)``, and the
  union of the boxes receives one copy of the embedding.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK_VALUE = -10000.0


def seq_len_to_hw(sequence_length: int, aspect_ratio: float) -> Tuple[int, int]:
    """Recover (height, width) from a flattened spatial length and h/w ratio
    by the reference's integer search."""
    width = int((sequence_length / aspect_ratio) ** 0.5)
    height = sequence_length // max(width, 1)
    while width * height != sequence_length:
        if width * height < sequence_length:
            width += 1
        else:
            width -= 1
        height = sequence_length // width
    return height, width


def _linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: the float32 quotient ``i / (n-1)``
    (``torch.linspace`` rounds some points differently, which moves bbox edges)."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    return torch.arange(n, dtype=torch.float32, device=device) / (n - 1)


def _pixel_grid(height: int, width: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened normalized pixel coordinates, row-major (y outer, x inner)."""
    x = _linspace01(width, device)
    y = _linspace01(height, device)
    return x.repeat(height), y.repeat_interleave(width)


def build_ip_attention_bias(bbox: torch.Tensor, height: int, width: int,
                            num_vision_tokens: int, num_dummy_tokens: int,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive attention bias for masked IP cross-attention.

    ``bbox``: ``[batch, max_num_ips, 4]`` relative [x1, y1, x2, y2].
    Returns ``[batch, height*width, num_dummy_tokens + max_num_ips*num_vision_tokens]``
    (0 where attendable, -10000 elsewhere).
    """
    xg, yg = _pixel_grid(height, width, bbox.device)          # [S]
    b = bbox.to(torch.float32)
    x1, y1 = b[..., 0][:, None, :], b[..., 1][:, None, :]      # [B, 1, I]
    x2, y2 = b[..., 2][:, None, :], b[..., 3][:, None, :]
    xg = xg[None, :, None]                                     # [1, S, 1]
    yg = yg[None, :, None]
    inside = (xg >= x1) & (xg <= x2) & (yg >= y1) & (yg <= y2)  # [B, S, I]

    zero = torch.zeros((), dtype=torch.float32, device=bbox.device)
    masked = torch.full((), MASK_VALUE, dtype=torch.float32, device=bbox.device)
    ip_bias = torch.where(inside, zero, masked)
    dummy_bias = torch.where(inside.any(dim=-1, keepdim=True), masked, zero)
    ip_bias = ip_bias.repeat_interleave(num_vision_tokens, dim=-1)
    dummy_bias = dummy_bias.expand(-1, -1, num_dummy_tokens)
    return torch.cat([dummy_bias, ip_bias], dim=-1).to(dtype)


def rasterize_dialog_embedding(sample: torch.Tensor, dialog_bbox: torch.Tensor,
                               embedding: torch.Tensor) -> torch.Tensor:
    """Add a learned channel embedding inside every dialog bbox.

    ``sample``: ``[batch, height, width, channels]`` (NHWC);
    ``dialog_bbox``: ``[batch, max_num_dialogs, 4]`` relative boxes;
    ``embedding``: ``[channels]``.
    """
    _, height, width, _ = sample.shape
    bb = dialog_bbox.to(torch.float32)
    x1 = torch.floor(bb[..., 0] * width)
    y1 = torch.floor(bb[..., 1] * height)
    x2 = torch.floor(bb[..., 2] * width)
    y2 = torch.floor(bb[..., 3] * height)
    xs = torch.arange(width, dtype=torch.float32, device=sample.device)
    ys = torch.arange(height, dtype=torch.float32, device=sample.device)
    in_y = (ys >= y1[..., None]) & (ys < y2[..., None])      # [B, D, H]
    in_x = (xs >= x1[..., None]) & (xs < x2[..., None])      # [B, D, W]
    inside = (in_y[:, :, :, None] & in_x[:, :, None, :]).any(dim=1)  # [B, H, W]
    add = inside[..., None].to(sample.dtype) * embedding.to(sample.dtype)
    return sample + add
