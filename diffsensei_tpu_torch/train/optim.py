"""Learning-rate schedules, trainable-parameter selection and the optimizer
(port of ``diffsensei_tpu/train/optim.py``).

* ``make_lr_schedule``: every name of the JAX registry (the reference's
  ``scripts/train/scheduler.py``), as a plain ``step -> lr`` function.
* ``unet_trainable_mask``: the reference's four selection modes
  ``full | lora | new | ip`` over the port's parameter names, which are the
  reference's (``..._ip`` projections, ``dialog_bbox_embedding``).
* ``partition_params`` / ``merge_partitioned``: the split into trainable and
  frozen parameters, as ``requires_grad``: frozen weights get no gradient
  buffers and no optimizer state.
* ``make_optimizer``: AdamW (``torch.optim.AdamW``, whose decoupled decay is
  optax's ``adamw``) after a global-norm clip with optax's rule, stepping the
  schedule per update, with ``optax.MultiSteps`` gradient accumulation. Under
  FSDP the parameters, gradients and moments are shards (DTensors): the
  global norm sums the shards' squares over the ranks, and AdamW steps each
  tensor alone (its fused loops do not mix shards and whole tensors). Under
  tensor parallelism a LLaMA parameter cut over the model axis is a plain
  tensor marked with it (``model_axis``, set by ``parallel.tensor.shard_llm``):
  the global norm sums its squares over the model ranks and counts the
  replicated ones once, so every model rank clips by the same factor.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from diffsensei_tpu_torch.parallel.train import is_sharded, local_like, local_part

Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# LR schedules (scheduler.py:18-128 of the reference)
# ---------------------------------------------------------------------------
def make_lr_schedule(name: str, base_lr: float, num_warmup_steps: int = 0,
                     num_training_steps: Optional[int] = None, min_lr_ratio: float = 0.0,
                     num_cycles: float = 0.5, power: float = 1.0,
                     lr_end: float = 1e-7) -> Schedule:
    """``step -> lr`` for every name of the JAX registry; ``reduce_on_plateau``
    is left out there too (it reads a validation metric)."""
    def warmup(step):
        if num_warmup_steps <= 0:
            return 1.0
        return min(1.0, step / num_warmup_steps)

    def progress(step):
        span = max(num_training_steps - num_warmup_steps, 1)
        return min(max((step - num_warmup_steps) / span, 0.0), 1.0)

    if name == "constant":
        return lambda step: base_lr
    if name == "constant_with_warmup":
        return lambda step: base_lr * warmup(step)
    if name == "linear":
        return lambda step: base_lr * warmup(step) * (1.0 - progress(step))
    if name in ("cosine", "cosine_with_min_lr"):
        floor = min_lr_ratio if name == "cosine_with_min_lr" else 0.0

        def cosine(step):
            cos = 0.5 * (1.0 + math.cos(math.pi * 2.0 * num_cycles * progress(step)))
            return base_lr * warmup(step) * (floor + (1.0 - floor) * cos)
        return cosine
    if name == "cosine_with_restarts":
        def restarts(step):
            p = progress(step)
            phase = math.fmod(max(num_cycles, 1) * p, 1.0)
            cos = 0.0 if p >= 1.0 else 0.5 * (1.0 + math.cos(math.pi * phase))
            return base_lr * warmup(step) * cos
        return restarts
    if name == "polynomial":
        def polynomial(step):
            decay = lr_end + (base_lr - lr_end) * (1.0 - progress(step)) ** power
            return warmup(step) * (base_lr if step < num_warmup_steps else decay)
        return polynomial
    if name == "inverse_sqrt":
        timescale = num_warmup_steps or 10_000
        shift = timescale - num_warmup_steps

        def inverse_sqrt(step):
            decay = 1.0 / math.sqrt(max((step + shift) / timescale, 1e-9))
            return base_lr * warmup(step) * (1.0 if step < num_warmup_steps else decay)
        return inverse_sqrt
    raise ValueError(f"unknown lr schedule: {name}")


# ---------------------------------------------------------------------------
# trainable-parameter selection (train.py:190-221 of the reference)
# ---------------------------------------------------------------------------
def unet_trainable_mask(unet: nn.Module, mode: str) -> Dict[str, bool]:
    """``{parameter name: trains}`` under the reference's modes: ``full``
    everything; ``new`` the IP projections and the dialog embedding (names
    with ``_ip`` or ``dialog``); ``ip`` the IP projections; ``lora`` the
    adapters plus the IP projections. Raises when a mode selects nothing."""
    def decide(name: str) -> bool:
        if mode == "full":
            return True
        if mode == "new":
            return "_ip" in name or "dialog" in name
        if mode == "ip":
            return "_ip" in name
        if mode == "lora":
            return "lora_" in name or "_ip" in name
        raise ValueError(f"unknown unet_trained_parameters mode: {mode}")

    mask = {name: decide(name) for name, _ in unet.named_parameters()}
    if not any(mask.values()):
        raise ValueError(f"unet_trained_parameters mode '{mode}' selects zero parameters"
                         + (" (the model has no LoRA adapters)" if mode == "lora" else ""))
    return mask


def partition_params(module: nn.Module, mask: Mapping[str, bool],
                     dtype: Optional[torch.dtype] = torch.float32
                     ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """Split ``module``'s parameters into ``(trainable, frozen)`` by ``mask``:
    ``requires_grad`` on the first, off on the second. Trainables are held in
    ``dtype`` (the flax ``param_dtype``: fp32 by default; None keeps each in
    its own dtype); the module keeps computing in its former dtype, since its
    layers cast at use."""
    if hasattr(module, "compute_dtype"):
        module.compute_dtype = module.dtype
    trainable, frozen = {}, {}
    for name, p in module.named_parameters():
        if mask[name]:
            if dtype is not None:
                p.data = p.data.to(dtype)
            trainable[name] = p.requires_grad_(True)
        else:
            frozen[name] = p.requires_grad_(False)
    return trainable, frozen


def merge_partitioned(trainable: Mapping[str, torch.Tensor],
                      frozen: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of ``partition_params``: one ``{name: tensor}`` map."""
    return {**trainable, **frozen}


def count_params(params: Mapping[str, torch.Tensor],
                 mask: Optional[Mapping[str, bool]] = None) -> int:
    return sum(p.numel() for name, p in params.items() if mask is None or mask[name])


def filter_trainable(params: Mapping[str, torch.Tensor],
                     mask: Mapping[str, bool]) -> Dict[str, torch.Tensor]:
    """The trainable entries only: what a stage-2/3 export keeps (the
    reference's ``get_trained_state_dict``)."""
    return {name: p for name, p in params.items() if mask[name]}


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
class Optimizer:
    """Global-norm clip, then AdamW at the schedule's rate for the update
    count, over ``params`` (the trainables). With ``accumulate = k > 1`` it
    keeps the running mean of k micro-steps' gradients and updates on every
    k-th call only (``optax.MultiSteps``); the schedule counts updates."""

    def __init__(self, params: Iterable[torch.Tensor], learning_rate, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 max_grad_norm: Optional[float] = 1.0, accumulate: int = 1):
        self.params = list(params)
        self.schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.max_grad_norm = max_grad_norm
        self.accumulate = accumulate
        self.updates = 0                     # optimizer updates taken
        self.micro = 0                       # micro-steps in the current accumulation
        self._acc = None
        sharded = any(is_sharded(p) for p in self.params)
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=betas,
                                       eps=eps, weight_decay=weight_decay,
                                       foreach=False if sharded else None)

    @staticmethod
    def _global_norm(grads, params) -> torch.Tensor:
        """optax's ``global_norm``: the squares of a gradient sharded under
        FSDP (a DTensor) are summed over the ranks that hold its shards,
        those of one cut over the model axis (its parameter's
        ``model_axis``) over the model ranks; whole gradients count once."""
        sums, whole = {}, []
        for g, p in zip(grads, params):
            axis = getattr(p, "model_axis", None)
            if is_sharded(g):
                sums.setdefault(g.device_mesh.get_group(), []).append(local_part(g))
            elif axis is not None:
                sums.setdefault(axis.group, []).append(g)
            else:
                whole.append(g)
        norm = lambda ts: torch.stack([torch.linalg.vector_norm(t.float()) for t in ts])
        if not sums:
            return torch.linalg.vector_norm(norm(whole))
        total = None
        for group, shards in sums.items():
            sq = norm(shards).square().sum()
            dist.all_reduce(sq, group=group)
            total = sq if total is None else total + sq.to(total.device)
        if whole:
            total = total + norm([g.to(total.device) for g in whole]).square().sum()
        return total.sqrt()

    def _clip(self, grads) -> None:
        if self.max_grad_norm is None:
            return
        norm = self._global_norm(grads, self.params)
        # optax.clip_by_global_norm: scale by max / norm where norm >= max
        factor = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                             self.max_grad_norm / norm)
        torch._foreach_mul_([local_part(g) for g in grads], factor)

    def step(self) -> bool:
        """Consume the parameters' ``.grad``; returns True when it updated."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        for p in self.params:
            p.grad = None
        if self.accumulate > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            self.micro += 1
            # running mean, as MultiSteps keeps it
            for a, g in zip(self._acc, grads):
                a.add_(g - a, alpha=1.0 / self.micro)
            if self.micro < self.accumulate:
                return False
            grads, self._acc, self.micro = self._acc, None, 0
        self._clip(grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.updates += 1
        return True

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "updates": self.updates,
                "micro": self.micro, "acc": self._acc}

    def load_state_dict(self, state: Dict) -> None:
        """Load a state of ``state_dict`` (or its whole-tensor gathering);
        each moment is put into its parameter's sharding."""
        adamw = state["adamw"]
        index = [i for g in adamw["param_groups"] for i in g["params"]]
        adamw = dict(adamw, state={
            i: {k: local_like(v, self.params[index.index(i)])
                if torch.is_tensor(v) and v.dim() else v for k, v in st.items()}
            for i, st in adamw["state"].items()})
        self.adamw.load_state_dict(adamw)
        self.updates, self.micro = state["updates"], state["micro"]
        self._acc = (None if state["acc"] is None
                     else [local_like(a, p) for a, p in zip(state["acc"], self.params)])


def make_optimizer(params: Iterable[torch.Tensor], learning_rate, weight_decay: float = 1e-2,
                   betas=(0.9, 0.999), eps: float = 1e-8,
                   max_grad_norm: Optional[float] = 1.0, accumulate: int = 1) -> Optimizer:
    """AdamW (+ global-norm clip) over the trainables ``params``; frozen
    parameters are simply not given to it."""
    return Optimizer(params, learning_rate, weight_decay, betas, eps, max_grad_norm,
                     accumulate)
