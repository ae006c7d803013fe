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

A stack with an ``agent`` (``benchmark/reference/agent.py``) draws the
agent apart, block by block, each block from a generator of its own keyed by
(seed, block): the embedding, each decoder layer, the final norm with the
head (the decoder's ``block_of`` names them), and each resampler. So the
SDXL draw is the same with an agent or without, and the reference redraws
one block at a time. The agent's names take the rules above; the one rule
added for it: a packed attention bias (``in_proj_bias``) is a bias.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
from typing import Dict, List, Tuple

import torch
from torch import nn

from benchmark.reference import agent as RA
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
    if name.endswith((".bias", "_bias")):
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


def agent_nets(stack: Dict) -> Dict[str, nn.Module]:
    """The agent's plain modules (parameters on the current default device)."""
    agent = stack["agent"]
    return dict(llm=RA.decoder(agent).build(RA.llm_config(agent)),
                input_resampler=RA.QwenResampler(agent["input_resampler"]),
                output_resampler=RA.QwenResampler(agent["output_resampler"]))


@functools.lru_cache(maxsize=None)
def _agent_layout(stack_json: str) -> Dict[str, Tuple[str, List[Tuple[str, Tuple[int, ...]]]]]:
    stack = json.loads(stack_json)
    block_of = RA.decoder(stack["agent"]).block_of
    with torch.device("meta"):
        nets = agent_nets(stack)
    out: Dict[str, Tuple[str, List]] = {}
    for net, mod in nets.items():
        for name, p in mod.named_parameters():
            block = f"llm.{block_of(name)}" if net == "llm" else net
            out.setdefault(block, (net, []))[1].append((name, tuple(p.shape)))
    return out


def agent_layout(stack: Dict) -> Dict[str, Tuple[str, List[Tuple[str, Tuple[int, ...]]]]]:
    """``{block: (network, [(name, shape), ...])}`` in draw order."""
    return _agent_layout(json.dumps(stack, sort_keys=True))


def block_seed(seed: int, block: str) -> int:
    """A block's generator seed: 63 bits of a hash of (seed, block)."""
    digest = hashlib.blake2b(f"{int(seed)}/{block}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


@torch.no_grad()
def agent_block(stack: Dict, seed: int, block: str, device,
                upcast: bool = False) -> Dict[str, torch.Tensor]:
    """One block of the agent's weights, ``{name: tensor}`` of its network,
    drawn on ``device`` in the stack's ``dtype`` (float32 with ``upcast``)."""
    device = torch.device(device)
    net, params = agent_layout(stack)[block]
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, block))
    flat = torch.randn(sum(_numel(s) for _, s in params), generator=gen,
                       dtype=DTYPES[stack["dtype"]], device=device)
    out, at = {}, 0
    for name, shape in params:
        view = flat[at:at + _numel(shape)].view(shape)
        at += _numel(shape)
        mean, std = scale_of(name, shape)
        view.mul_(std)
        if mean:
            view.add_(mean)
        out[name] = view.float() if upcast else view
    return out


def make_agent(stack: Dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{network: state dict}`` of the whole agent, every block drawn."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for block, (net, _) in agent_layout(stack).items():
        out.setdefault(net, {}).update(agent_block(stack, seed, block, device))
    return out


@contextlib.contextmanager
def placed(module: nn.Module, params: Dict[str, torch.Tensor]):
    """``module``'s parameters named in ``params`` set to those tensors while
    the block runs, then back on the meta device (their memory freed)."""
    def put(name, t):
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, nn.Parameter(t, requires_grad=False))
    for name, t in params.items():
        put(name, t)
    try:
        yield
    finally:
        for name, t in params.items():
            put(name, torch.empty(t.shape, device="meta"))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
