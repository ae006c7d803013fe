"""Tensor parallelism of the SEED-X LLaMA over the mesh's model axis (port
of ``llm_param_sharding_rules``, ``diffsensei_tpu/parallel/mesh.py:76``,
and of the collectives XLA inserts into the sharded agent,
``diffsensei_tpu/models/mllm/seed_x.py:195-212,265-285``).

Megatron's layout (``mesh.llm_param_sharding_rules``): each rank holds
``num_heads / tp`` query heads and ``num_kv_heads / tp`` KV heads with their
slice of the KV cache; q/k/v and gate/up are column-parallel (their input
goes through ``copy_to_model``: identity forward, all-reduce backward), o
and down row-parallel (their partial output through ``reduce_from_model``:
all-reduce forward, identity backward). The embedding and ``lm_head`` split
the vocabulary in ``vocab_range``'s ceil-sized rows, the last rank's
shorter: a lookup outside the rank's rows is zero before the all-reduce,
and the logits are gathered by an all-reduce of zero-padded slices
(``gather_vocab``), whose backward takes the rank's own slice and sums
nothing: the loss after the gather is the same on every rank, so its
gradient is already whole there.

LoRA follows its base. In a column layer A is replicated and B split on its
output; A reads the input before ``copy_to_model`` and its output goes
through ``copy_to_model`` itself, so A's gradient and the input's are each
summed once. In a row layer A is split on its input and B replicated; the
LoRA term joins the base's partial sum before the one all-reduce, and B's
gradient, a partial sum on each rank, is summed over the ranks in the
backward (the weight goes through ``copy_to_model``). Every replicated trainable (norms,
resamplers, the replicated halves of LoRA) thus gets the same whole
gradient on every model rank.

Every collective is an all-reduce, which gloo also takes for CUDA tensors,
so ranks that share one card can run it. ``model_axis_schedule`` runs the
``tp`` ranks' shard sets in one process instead (as
``ops/ring_attention.py::ring_schedule`` runs the ring's chunks), for the
card where one process holds them all: each shard set's own
``LlamaForCausalLM.forward`` in a thread of its own, the threads taking
turns in rank order, on a ``ScheduleGroup`` whose all-reduce is the ranks'
sum in rank order, in fp32 as ``_all_reduce`` adds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from diffsensei_tpu_torch.ops import int4_matmul as i4
from diffsensei_tpu_torch.parallel.mesh import llm_param_sharding_rules, sharded_dim


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """A rank's place on the model axis: its rank, the axis's size and the
    group its all-reduces run on (a process group, or a ``ScheduleRank``)."""

    rank: int
    size: int
    group: object


class ScheduleGroup:
    """The model axis of ``model_axis_schedule``: ``size`` ranks' shard sets
    held by one process. ``run`` calls each rank's job in a thread of its
    own; the threads take turns in rank order, each running until its next
    all-reduce, where the last rank adds the ranks' tensors in rank order
    and hands the sum to all. One job alone runs in the calling thread, its
    all-reduces the identity (a rank's own work, as for timing it)."""

    def __init__(self, size: int):
        self.size = size
        self._cond = threading.Condition()
        self._order: Optional[List[int]] = None     # the running ranks, in rank order

    def run(self, jobs: Mapping[int, Callable[[], object]]) -> Dict[int, object]:
        """``{rank: job()}`` for the ranks of ``jobs``, run as set out above."""
        if self._order is not None:
            raise RuntimeError("the schedule's group is already running")
        order = sorted(jobs)
        self._order, self._turn, self._round, self._slots = order, 0, 0, {}
        self._done, self._error = 0, None
        try:
            if len(order) == 1:
                return {order[0]: jobs[order[0]]()}
            results: Dict[int, object] = {}
            state = _thread_state()
            threads = [threading.Thread(target=self._work, daemon=True,
                                        args=(i, jobs[r], results, state))
                       for i, r in enumerate(order)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if self._error is not None:
                raise self._error
            return results
        finally:
            self._order = None

    def _work(self, i, job, results, state) -> None:
        try:
            with self._cond:
                self._wait(lambda: self._turn == i)
            with state():
                results[self._order[i]] = job()
        except BaseException as e:                   # handed to run; the others stop
            with self._cond:
                self._error = self._error or e
                self._cond.notify_all()
            return
        with self._cond:
            self._done += 1
            self._turn = i + 1
            self._cond.notify_all()

    def _wait(self, ready, pending=None) -> None:
        """Under the lock: wait until ``ready()``; raise if a rank failed, or
        left the schedule while the all-reduce ``pending()`` lacks it."""
        while not ready():
            if self._error is not None:
                raise RuntimeError("another rank of the schedule failed")
            if self._done and pending is not None and pending():
                raise RuntimeError("a rank left the schedule before the all-reduce")
            self._cond.wait()

    def all_reduce_(self, y: torch.Tensor, rank: int) -> None:
        """Rank ``rank``'s all-reduce: y becomes the running ranks' sum."""
        if self._order is None:
            raise RuntimeError("a shard set of model_axis_schedule runs inside it only")
        if len(self._order) == 1:
            return
        i, last = self._order.index(rank), len(self._order) - 1
        with self._cond:
            self._slots[i] = y
            if i < last:
                now = self._round
                self._turn = i + 1
                self._cond.notify_all()
                self._wait(lambda: self._round > now and self._turn == i,
                           pending=lambda: self._round == now)
                return
            if len(self._slots) < len(self._order):
                raise RuntimeError("a rank left the schedule before the all-reduce")
            total = _rank_sum([self._slots[j] for j in range(len(self._order))])
            for j in range(last):
                self._slots[j].copy_(total)
            y.copy_(total)
            self._slots, self._turn = {}, 0
            self._round += 1
            self._cond.notify_all()
            self._wait(lambda: self._turn == i)


@dataclasses.dataclass(frozen=True)
class ScheduleRank:
    """Rank ``rank`` of a ``ScheduleGroup``: what a shard set of
    ``model_axis_schedule`` takes as its ``tp_group``."""

    schedule: ScheduleGroup
    rank: int


def _thread_state():
    """The calling thread's autograd mode and CUDA stream, to enter in a
    schedule's threads (each thread starts with its own)."""
    inference, grad = torch.is_inference_mode_enabled(), torch.is_grad_enabled()
    stream = torch.cuda.current_stream() if torch.cuda.is_initialized() else None

    def enter():
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode(inference))
        stack.enter_context(torch.set_grad_enabled(grad))
        if stream is not None:
            stack.enter_context(torch.cuda.stream(stream))
        return stack
    return enter


def model_axis(group=None) -> Optional[ModelAxis]:
    """The axis of ``group`` (a process group, with this process's rank in
    it, or a ``ScheduleRank``); None for a single rank."""
    if group is None:
        return None
    if isinstance(group, ScheduleRank):
        rank, size = group.rank, group.schedule.size
    else:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    if not 0 <= rank < size:
        raise ValueError(f"model rank {rank} outside an axis of {size}")
    return None if size == 1 else ModelAxis(rank, size, group)


# ---------------------------------------------------------------------------
# the collectives (each a no-op without an axis)
# ---------------------------------------------------------------------------
def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' sum of x in x's dtype, added in fp32 for a 16-bit x (its
    partial sums rounded once, after the sum; gloo takes fp32 anyway)."""
    y = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.contiguous().clone()
    if isinstance(group, ScheduleRank):
        group.schedule.all_reduce_(y, group.rank)
    else:
        dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group, start, vocab):
        ctx.start, ctx.width = start, local.shape[-1]
        out = local.new_zeros(tuple(local.shape[:-1]) + (vocab,))
        out[..., start:start + local.shape[-1]] = local
        return _all_reduce(out, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.start:ctx.start + ctx.width].contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The input of a column-parallel layer (or a replicated weight whose
    gradient is a partial sum on each rank, a row layer's LoRA B): x
    forward, the ranks' summed gradient backward."""
    if axis is None:
        return x
    return _Copy.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The output of a row-parallel layer: the ranks' partial sums summed
    forward, the gradient as it is backward."""
    if axis is None:
        return x
    return _Reduce.apply(x, axis.group)


def gather_vocab(local: torch.Tensor, axis: Optional[ModelAxis], start: int,
                 vocab: int) -> torch.Tensor:
    """The whole ``[..., vocab]`` from each rank's columns
    ``[start, start + local.shape[-1])``: zero-padded slices all-reduced.
    The backward hands each rank its own slice of the gradient."""
    if axis is None:
        return local
    return _GatherVocab.apply(local, axis.group, start, vocab)


# ---------------------------------------------------------------------------
# what each rank holds
# ---------------------------------------------------------------------------
def vocab_range(vocab: int, rank: int, size: int) -> Tuple[int, int]:
    """Rank ``rank``'s rows of the vocabulary: ceil(vocab / size) each, the
    last rank's shorter (32330 over 4: 8083, 8083, 8083, 8081)."""
    rows = -(-vocab // size)
    if rows * (size - 1) >= vocab:
        raise ValueError(f"a vocabulary of {vocab} leaves a rank of {size} without rows")
    return rank * rows, min((rank + 1) * rows, vocab)


def even_range(n: int, rank: int, size: int, what: str) -> Tuple[int, int]:
    if n % size:
        raise ValueError(f"{what}: {n} does not split over {size} model ranks")
    return rank * (n // size), (rank + 1) * (n // size)


_PROJECTIONS = {"q_proj": "column", "k_proj": "column", "v_proj": "column",
                "gate_proj": "column", "up_proj": "column",
                "o_proj": "row", "down_proj": "row"}


def projection_shape(config, name: str) -> Tuple[int, int]:
    """``(in, out)`` of a whole projection of the LLaMA (``q_proj``, ...,
    ``lm_head``)."""
    d, hd, f = config.hidden_size, config.head_dim, config.intermediate_size
    return {"q_proj": (d, config.num_heads * hd), "k_proj": (d, config.num_kv_heads * hd),
            "v_proj": (d, config.num_kv_heads * hd), "o_proj": (config.num_heads * hd, d),
            "gate_proj": (d, f), "up_proj": (d, f), "down_proj": (f, d),
            "lm_head": (d, config.vocab_size)}[name]


def check_model_axis(config, size: int, quantized=False, group: int = 128) -> None:
    """Raise ``ValueError`` where the LLaMA does not split over ``size``
    model ranks: heads or KV heads (each rank's query heads must read its
    own KV heads), a projection's split dimension, the vocabulary, or, for
    int4, a row layer's input cut inside a scale group (``g = gcd(group,
    in)``: SEED-X's down_proj, 13824 = 108 x 128, splits over 1, 2 or 4
    ranks and not over 8)."""
    for what, n in (("num_heads", config.num_heads), ("num_kv_heads", config.num_kv_heads)):
        if n % size:
            raise ValueError(f"{what} = {n} does not split over {size} model ranks")
    for name, kind in _PROJECTIONS.items():
        in_f, out_f = projection_shape(config, name)
        even_range(out_f if kind == "column" else in_f, 0, size, name)
        if kind == "row" and str(quantized) == "int4" and (in_f // size) % math.gcd(group, in_f):
            raise ValueError(f"{name}: an int4 input of {in_f // size} a rank (tp = {size}) "
                             f"cuts a scale group of {math.gcd(group, in_f)}")
    vocab_range(config.vocab_size, 0, size)


def _projection(name: str) -> str:
    """The projection a state-dict name belongs to (``q_proj``, ...,
    ``lm_head``), or ""."""
    if name.startswith("lm_head."):
        return "lm_head"
    return next((proj for proj in _PROJECTIONS if f".{proj}." in name), "")


def shard_llama_state(state: Mapping[str, torch.Tensor], config, rank: int,
                      size: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shards of a whole LLaMA state dict (the port's names)
    over ``size`` model ranks, in the layout the state is in (dense or bf16
    weights with or without LoRA, int8, packed int4), each cut on the device
    its tensor is on, one layer at a time. The cut dimension is the one
    ``mesh.llm_param_sharding_rules`` names; the vocabulary's rows are
    ``vocab_range``'s; an int4 column cut is repacked
    (``ops/int4_matmul.py::shard_int4_columns``) and an int4 row cut may
    not fall inside a scale group. Replicated tensors are passed through."""
    quantized = "int4" if any(v.dtype == torch.uint8 for v in state.values()) else False
    check_model_axis(config, size, quantized)
    rules = llm_param_sharding_rules()
    out: Dict[str, torch.Tensor] = {}
    for name, value in state.items():
        dim = sharded_dim(name, value.dim(), rules)
        proj = _projection(name)
        if dim is None:
            out[name] = value
            continue
        if proj == "lm_head" or name == "embed_tokens.weight":
            start, stop = vocab_range(config.vocab_size, rank, size)
        else:
            in_f, out_f = projection_shape(config, proj)
            start, stop = even_range(out_f if _PROJECTIONS[proj] == "column" else in_f,
                                     rank, size, proj)
        owner = name.rsplit(".", 1)[0] + "."
        if state.get(owner + "kernel_q", torch.empty(0)).dtype == torch.uint8:
            if name.endswith("kernel_scale"):
                continue                        # cut with its kernel_q
            packed, scale = value, state[owner + "kernel_scale"]
            if proj == "lm_head" or _PROJECTIONS[proj] == "column":
                packed, scale = i4.shard_int4_columns(packed, scale, start, stop)
            else:
                packed, scale = i4.shard_int4_rows(packed, scale, start, stop)
            out[name], out[owner + "kernel_scale"] = packed, scale
            continue
        out[name] = value.narrow(dim, start, stop - start).contiguous()
    return out


def shard_llm(llm, group=None):
    """A ``LlamaForCausalLM`` holding this rank's shards of ``llm`` (on its
    device, in its dtype and layout, its remat, compute dtype, train mode
    and ``requires_grad`` flags kept) on the model axis ``group``: a process
    group, or a ``ScheduleRank`` for a shard set of ``model_axis_schedule``.
    Each parameter cut over the axis carries it as ``model_axis``, which the
    optimizer's global norm reads."""
    from diffsensei_tpu_torch.models.mllm.llama import LlamaForCausalLM

    axis = model_axis(group)
    if axis is None:
        return llm
    device = llm.embed_tokens.weight.device
    state = shard_llama_state(llm.state_dict(), llm.config, axis.rank, axis.size)
    with torch.device("meta"):
        out = LlamaForCausalLM(llm.config, lora_rank=llm.lora_rank, quantized=llm.quantized,
                               dtype=llm._dtype, tp_group=group)
    out.to_empty(device=device)
    for name, p in out.named_parameters():     # each shard in its whole tensor's dtype
        if p.dtype != state[name].dtype:
            p.data = torch.empty_like(state[name], device=device)
    out.load_state_dict(state)
    wants_grad = {n: p.requires_grad for n, p in llm.named_parameters()}
    rules = llm_param_sharding_rules()
    for name, p in out.named_parameters():
        p.requires_grad_(wants_grad[name])
        if sharded_dim(name, p.dim(), rules) is not None:
            p.model_axis = axis
    out.compute_dtype = llm.compute_dtype
    out.remat, out.remat_policy = llm.remat, llm.remat_policy
    return out.train(llm.training)


# ---------------------------------------------------------------------------
# the model axis in one process
# ---------------------------------------------------------------------------
def shard_sets(llm, size: int) -> List:
    """The ``size`` ranks' shard sets of ``llm`` on one ``ScheduleGroup``,
    for ``model_axis_schedule``."""
    schedule = ScheduleGroup(size)
    return [shard_llm(llm, ScheduleRank(schedule, rank)) for rank in range(size)]


def _rank_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return functools.reduce(torch.add, parts)


def model_axis_schedule(shards: Sequence, input_ids=None, inputs_embeds=None, positions=None,
                        caches: Optional[Sequence[List]] = None,
                        cache_index: Optional[int] = None):
    """What ``LlamaForCausalLM(..., tp_group=g)`` computes on ``len(shards)``
    ranks, in one process: every shard set (``shard_sets``, in rank order)
    runs its own forward on its ``ScheduleGroup``, whose all-reduces add
    the ranks' tensors in rank order. ``caches`` is one list of per-layer
    caches a shard set (``init_caches(..., tp=size)``). Returns ``(logits,
    hidden, caches)``: the logits and hidden state every rank returns, and
    each shard set's new caches. A single shard set of a larger axis runs
    alone, its all-reduces the identity: its rank's work, not the
    logits."""
    schedule = shards[0].axis.group.schedule

    def job(i):
        return lambda: shards[i](input_ids=input_ids, inputs_embeds=inputs_embeds,
                                 positions=positions,
                                 caches=None if caches is None else caches[i],
                                 cache_index=cache_index)

    out = schedule.run({sh.axis.rank: job(i) for i, sh in enumerate(shards)})
    outs = [out[sh.axis.rank] for sh in shards]
    logits, hidden, _ = outs[0]
    return logits, hidden, (None if caches is None else [o[2] for o in outs])
