"""The reference in fp8: a copy of a module whose matmuls and convolutions
take their weights and inputs rounded to e4m3 with one scale a tensor (its
largest magnitude onto 448), the arithmetic itself in the module's own
precision. It stands for a program that runs those products in fp8."""

from __future__ import annotations

import copy

import torch
from torch import nn


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    return ((t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale).to(t.dtype)


@torch.no_grad()
def fp8_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` with every ``nn.Linear`` and ``nn.Conv2d``
    computing on fp8-rounded weights and inputs."""
    out = copy.deepcopy(module)
    for mod in out.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            mod.weight.copy_(round_fp8(mod.weight))
            mod.register_forward_pre_hook(lambda m, args: (round_fp8(args[0]),) + tuple(args[1:]))
    return out
