"""Data-parallel and FSDP training (port of the JAX train CLI's
``trainer.parallel``, ``diffsensei_tpu/train/cli.py:313-334``, and of the
collectives XLA inserts into its sharded step).

* ``dp``: the trainables sit in ``DistributedDataParallel``
  (``wrap_ddp``), which averages their gradients over the data axis's
  ranks (all ranks, or on a ``(data, model)`` mesh the ranks of this
  rank's model shard, ``mesh.data_group``; the model axis's collectives
  are the LLaMA's own, ``parallel/tensor.py``).
* ``fsdp``: FSDP2 ``fully_shard`` over the trainable modules and the frozen
  stack (``fsdp_train``; for stage 3 the agent's LLaMA and resamplers
  trained, the UNet and the Resampler with the frozen stack): each
  parameter of at least ``fsdp_min_size``
  elements sharded on the dimension ``mesh.fsdp_spec`` picks, its gradient
  reduce-scattered and its AdamW moments sharded with it; the smaller ones
  stay whole on every rank, outside the FSDP groups, their gradients
  averaged by ``sync_replicated_grads``.

Under either, a step equals the single-process step on the global batch
(the ranks' rows together, ``mesh.host_rows``), given three rules the step
functions keep (``train/diffusion.py``, ``train/mllm_step.py``):

1. every rank draws the noise and timesteps of the global batch from the
   step's generator and takes its own rows, so no rank trains on noise the
   single process would not have drawn;
2. a loss that is a mean over a rank's rows or tokens is scaled by
   ``rank_weight``, ``count_r * world / sum(count)``, so that the average
   the gradient sync takes is the global masked mean (ranks of a padded
   batch hold different counts);
3. a loss over the whole batch (the IP contrastive loss) sees the global
   batch through ``gather_rows``, whose backward sums the ranks' gradients.

``reduce_metrics`` averages the step's scalars over the ranks (and sums the
panel count), so each rank logs the global values. ``full_state`` gathers a
state dict's sharded tensors whole for a checkpoint that rank 0 writes with
the names and shapes of a single-process run; ``local_like`` puts a whole
tensor back into a parameter's sharding on resume.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Set

import torch
import torch.distributed as dist
from torch import nn

from diffsensei_tpu_torch.parallel.mesh import FSDP_MIN_SIZE, Distributed, fsdp_spec

PARALLEL_MODES = ("dp", "fsdp")


# ---------------------------------------------------------------------------
# the step's reductions
# ---------------------------------------------------------------------------
def rank_weight(count: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``count * world / max(sum over ranks of count, 1)``: the factor that
    turns this rank's mean over ``count`` items into its share of the global
    mean, once the gradient sync averages over the ranks. Exactly 1.0 for a
    world of one rank."""
    count = count.detach().float().reshape(())
    total = count.clone()
    dist.all_reduce(total, group=group)
    return count * dist.get_world_size(group) / total.clamp(min=1.0)


class _GatherRows(torch.autograd.Function):
    """All ranks' rows in global order; the backward sums the ranks'
    gradients of this rank's rows. Built on all-reduce, which gloo also
    takes for CUDA tensors."""

    @staticmethod
    def forward(ctx, x, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.rank, ctx.world = group, rank, world
        buf = x.new_zeros((world,) + tuple(x.shape))
        buf[rank] = x
        dist.all_reduce(buf, group=group)
        # rank r holds global rows r::world: row j is rank j % world's row j // world
        return buf.transpose(0, 1).reshape((x.shape[0] * world,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        g = grad.reshape((-1, ctx.world) + tuple(grad.shape[1:])).transpose(0, 1).contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank], None


def gather_rows(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The global batch of a per-rank tensor whose rows are ``host_rows``
    of it, differentiable (``_GatherRows``)."""
    return _GatherRows.apply(x, group)


def reduce_metrics(metrics: Dict[str, torch.Tensor],
                   group: Optional[dist.ProcessGroup]) -> Dict[str, torch.Tensor]:
    """The ranks' mean of every scalar, their sum of ``panels``."""
    if group is None:
        return metrics
    names = sorted(metrics)
    device = metrics["loss"].device
    vals = torch.stack([metrics[k].detach().float().reshape(()).to(device) for k in names])
    dist.all_reduce(vals, group=group)
    world = dist.get_world_size(group)
    return {k: v if k == "panels" else v / world for k, v in zip(names, vals.unbind())}


# ---------------------------------------------------------------------------
# dp: DistributedDataParallel
# ---------------------------------------------------------------------------
class _LossModule(nn.Module):
    """The trainable modules of a step under one module, whose forward is
    the step's ``loss_fn``: what DDP wraps."""

    def __init__(self, loss_fn: Callable, modules: Dict[str, nn.Module]):
        super().__init__()
        self.loss_fn = loss_fn
        self.parts = nn.ModuleDict(modules)

    def forward(self, *args, **kwargs):
        return self.loss_fn(*args, **kwargs)


def wrap_ddp(step: Callable, modules: Dict[str, nn.Module], env: Distributed,
             group: Optional[dist.ProcessGroup] = None) -> nn.Module:
    """Run ``step``'s forward through DDP over the parameters of
    ``modules`` that require a gradient, averaged over ``group`` (the data
    axis; all ranks by default); frozen parameters and buffers are left out
    of its broadcasts and buckets. Unused trainables (stage 1's IP
    projections) are allowed."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    holder = _LossModule(step.loss_fn, modules)
    ignored = [n for n, p in holder.named_parameters() if not p.requires_grad]
    ignored += [n for n, _ in holder.named_buffers()]
    DDP._set_params_and_buffers_to_ignore_for_model(holder, ignored)
    ddp = DDP(holder, device_ids=[env.device.index] if env.device.type == "cuda" else None,
              process_group=env.group if group is None else group,
              find_unused_parameters=True)
    step.forward = ddp
    return ddp


# ---------------------------------------------------------------------------
# fsdp: FSDP2 fully_shard
# ---------------------------------------------------------------------------
# the frozen modules a train step runs (``train.diffusion.FrozenDiffusionStack``)
FROZEN_STACK = ("vae", "text_encoder", "text_encoder_2", "image_encoder", "magi_encoder")


def fsdp_train(step: Callable, trained: Dict[str, nn.Module], frozen,
               params: Dict[str, nn.Parameter], env: Distributed,
               min_size: int = FSDP_MIN_SIZE,
               frozen_modules: Optional[Dict[str, nn.Module]] = None) -> Dict[str, nn.Parameter]:
    """Shard a step's modules with FSDP2 over the data axis, as the JAX CLI
    shards its trainables and frozen stack (``cli.py:313-334``): each
    parameter on the dimension ``fsdp_spec`` picks; those it replicates are
    left out of FSDP, whole on every rank. Every resnet block, transformer
    stack and LLaMA layer is a unit; each trainable module, each module of
    the frozen stack and each of ``frozen_modules`` (stage 3's UNet and
    Resampler, which its backward runs through) a root, the frozen stack's
    resharded after their forward (no backward comes to free them). The
    LLaMA's ``embed_tokens_only`` is a forward method of its root.
    Returns the trainables ``params`` (named ``"<module>.<name>"``) as the
    sharded parameters now are, and sets ``step.sync_grads`` to average the
    gradients of those kept whole."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    from diffsensei_tpu_torch.models.layers import ResnetBlock2D
    from diffsensei_tpu_torch.models.mllm.llama import LlamaForCausalLM, LlamaLayer
    from diffsensei_tpu_torch.models.unet import Transformer2D
    from diffsensei_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=env.device)["data"]
    placement = lambda p: Shard(fsdp_spec(tuple(p.shape), env.world, min_size))
    stack = {n: getattr(frozen, n) for n in FROZEN_STACK if getattr(frozen, n) is not None}
    units = {**trained, **(frozen_modules or {})}
    whole: Set[nn.Parameter] = set()
    for name, root in {**units, **stack}.items():
        # FSDP takes contiguous parameters only (the sdxl preset lays its conv
        # weights out channels-last); its unsharded copies are contiguous anyway
        for p in root.parameters():
            if not p.is_contiguous():
                p.data = p.data.contiguous()
        kept = {p for p in root.parameters()
                if fsdp_spec(tuple(p.shape), env.world, min_size) is None}
        whole |= kept
        if name in units:
            for unit in root.modules():
                if isinstance(unit, (ResnetBlock2D, Transformer2D, LlamaLayer)):
                    fully_shard(unit, mesh=mesh, shard_placement_fn=placement,
                                ignored_params={p for p in unit.parameters() if p in kept})
        fully_shard(root, mesh=mesh, shard_placement_fn=placement, ignored_params=kept,
                    reshard_after_forward=True if name in stack else None)
        if isinstance(root, LlamaForCausalLM):
            register_fsdp_forward_method(root, "embed_tokens_only")
    register_fsdp_forward_method(stack["vae"], "encode")
    live = {f"{prefix}.{n}": p for prefix, mod in trained.items()
            for n, p in mod.named_parameters()}
    params = {k: live[k] for k in params}
    replicated = [p for p in params.values() if p in whole]
    step.sync_grads = lambda: sync_replicated_grads(replicated, env.group)
    return params


def sync_replicated_grads(params: Iterable[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Average the gradients of the parameters FSDP leaves whole (one
    all-reduce over their flattened gradients)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or dist.get_world_size(group) == 1:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# ---------------------------------------------------------------------------
# state: whole tensors for files, shards for the run
# ---------------------------------------------------------------------------
def is_sharded(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def full_state(obj: Any) -> Any:
    """``obj`` (nested dicts, lists, tuples) with every sharded tensor
    gathered whole onto the host; a collective every rank must call."""
    if is_sharded(obj):
        return obj.full_tensor().cpu()
    if isinstance(obj, dict):
        return {k: full_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(full_state(v) for v in obj)
    return obj


def local_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A whole tensor put into ``like``'s sharding (this rank's shard of it
    as a DTensor), or moved to ``like``'s device where ``like`` is whole."""
    if not is_sharded(like):
        return full.to(like.device)
    from torch.distributed.tensor import DTensor

    mesh, placements = like.device_mesh, like.placements
    local = full
    for axis, pl in enumerate(placements):
        if pl.is_shard():
            n, r = mesh.size(axis), mesh.get_local_rank(axis)
            local = local.chunk(n, dim=pl.dim)[r]
    return DTensor.from_local(local.to(like.to_local().device).contiguous(), mesh, placements,
                              run_check=False)


def local_part(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``t``: its shard's tensor, or ``t`` itself."""
    return t.to_local() if is_sharded(t) else t
