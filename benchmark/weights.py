"""Seeded weights for the whole stack, made on the device in one draw a dtype.

The program and the reference load the same values under the same names:
the parameter list comes from the reference's modules (built on the meta
device) and the program's state dicts must name the same tensors. Every
network but the VAE is drawn in the stack's ``dtype`` (bf16), the VAE in
``vae_dtype``: one ``torch.randn`` over all of a dtype's parameters, then
each slice scaled in place. The reference takes the same draw and upcasts
each slice, so both sides hold the same numbers.

Scales: weights of rank 2 and up ~ N(0, 1/fan_in) (fan_in = size / rows);
norm scales 1 + N(0, 0.02^2); biases N(0, 0.02^2); ViT class and position
embeddings and the text position table N(0, 0.02^2); the Resampler's
latents N(0, 1/dim); its dummy tokens and the dialog embedding, which are
added to activations of unit scale, N(0, 1) and N(0, 0.5^2).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import nets as N

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
SMALL = ("class_embedding", "cls_token", "position_embeddings",
         "embeddings.position_embedding.weight")


def scale_of(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of one parameter."""
    if name.endswith("dialog_bbox_embedding"):
        return 0.0, 0.5
    if name == "dummy_tokens":
        return 0.0, 1.0
    if name == "latents":
        return 0.0, shape[-1] ** -0.5
    if name.endswith(SMALL):
        return 0.0, 0.02
    if len(shape) >= 2:
        rows = shape[0]
        fan_in = 1
        for s in shape[1:]:
            fan_in *= s
        return 0.0, fan_in ** -0.5 if rows else 1.0
    if name.endswith(".bias"):
        return 0.0, 0.02
    return 1.0, 0.02


def layout(stack: Dict) -> List[Tuple[str, str, Tuple[int, ...], torch.dtype]]:
    """(network, name, shape, dtype) of every parameter, in draw order."""
    with torch.device("meta"):
        nets = N.build(stack)
    out = []
    for net in N.NETS:
        dtype = DTYPES[stack["vae_dtype"] if net == "vae" else stack["dtype"]]
        out += [(net, name, tuple(p.shape), dtype) for name, p in nets[net].named_parameters()]
    return out


@torch.no_grad()
def make(stack: Dict, seed: int, device, upcast: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{network: state dict}`` drawn from ``seed`` on ``device``; with
    ``upcast`` every tensor is float32 (the reference's copy of the same
    values)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = layout(stack)
    out: Dict[str, Dict[str, torch.Tensor]] = {net: {} for net in N.NETS}
    for dtype in dict.fromkeys(p[3] for p in params):
        mine = [p for p in params if p[3] == dtype]
        total = sum(_numel(p[2]) for p in mine)
        flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
        at = 0
        for net, name, shape, _ in mine:
            n = _numel(shape)
            view = flat[at:at + n].view(shape)
            at += n
            mean, std = scale_of(name, shape)
            view.mul_(std)
            if mean:
                view.add_(mean)
            out[net][name] = view.float() if upcast else view
        del flat
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
