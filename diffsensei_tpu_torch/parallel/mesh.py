"""Process groups, the ``(data, model)`` device mesh, the LLaMA's tensor-
parallel rules, FSDP sharding specs and the per-rank rows of a batch (port
of ``diffsensei_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over the devices it sees and
lets XLA insert the collectives. The port runs one process a rank under
``python -m torch.distributed.run`` (or alone, as a world of one) and makes
them itself: DDP's gradient all-reduce, FSDP2's all-gathers and
reduce-scatters, the ring's sends (``ops/ring_attention.py``), the
batch-sharded serving's all-gather (``pipelines/pipeline.py``) and the
model axis's all-reduces (``parallel/tensor.py``).

The backend is NCCL where each rank has its own card and gloo on the CPU.
NCCL refuses two ranks on one card; where the launcher puts more ranks on a
host than it has cards, the ranks share them over gloo, which takes CUDA
tensors for broadcast and all-reduce only: enough for DDP and the model
axis, whose collectives are all all-reduces, not for FSDP or the ring. The
mesh puts ``model`` innermost, as the JAX one does: the ranks
``d * model + m`` for ``m < model`` share data rank ``d``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Ranks along each mesh axis: ``data`` (batch rows) and ``model``
    (tensor parallelism for the LLaMA agent, ``parallel/tensor.py``)."""

    data: int
    model: int = 1

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"each mesh axis needs at least one rank, got data={self.data}, "
                             f"model={self.model}")

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclasses.dataclass(frozen=True)
class Distributed:
    """This process's place in the default process group."""

    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def group(self) -> dist.ProcessGroup:
        return dist.group.WORLD

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes files."""
        return self.rank == 0


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def resolve_device(device=None) -> torch.device:
    """The rank's device: the card ``cuda:$LOCAL_RANK`` (modulo the cards a
    host has, where ranks share them) unless ``device`` names another."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", _env_int("LOCAL_RANK", 0) % count)
    return device


def backend_for(device: torch.device) -> str:
    """gloo on the CPU and where a host's ranks outnumber its cards (NCCL
    refuses two ranks on one card), else NCCL."""
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no process-group backend for device {device}")
    local_world = _env_int("LOCAL_WORLD_SIZE", 1)
    return "gloo" if local_world > torch.cuda.device_count() else "nccl"


def init_distributed(device=None) -> Distributed:
    """Join (or make) the default process group and pick the rank's device.

    Under a launcher it reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
    (torchrun's) and rendezvouses through ``env://``; without them it makes
    a group of one rank in this process, as the JAX CLI meshes over the
    devices it sees. A group that is already up is joined as it is; a
    failed init raises."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend_for(device)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    rank=_env_int("RANK", 0),
                                    world_size=_env_int("WORLD_SIZE", 1),
                                    device_id=device if backend == "nccl" else None)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    backend = dist.get_backend()
    if (backend == "nccl") != (device.type == "cuda" and backend_for(device) == "nccl"):
        raise ValueError(f"the process group runs {backend}, which does not serve {device}")
    return Distributed(rank=dist.get_rank(), world=dist.get_world_size(), device=device,
                       backend=backend)


def make_mesh(spec: Optional[MeshSpec] = None, device=None):
    """The ``(data, model)`` device mesh over every rank (``init_device_mesh``);
    ``spec`` defaults to all ranks on the data axis and must cover them."""
    from torch.distributed.device_mesh import init_device_mesh

    env = init_distributed(device)
    spec = spec or MeshSpec(data=env.world)
    if spec.num_devices != env.world:
        raise ValueError(f"mesh {spec} needs {spec.num_devices} ranks, the group has "
                         f"{env.world}")
    return init_device_mesh(env.device.type, (spec.data, spec.model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_group(mesh) -> dist.ProcessGroup:
    """The process group along the mesh's data axis: the ranks that hold
    the same model shard and different rows."""
    return mesh.get_group(DATA_AXIS)


def model_group(mesh) -> dist.ProcessGroup:
    """The process group along the mesh's model axis: the ranks that hold
    the same rows and different shards of the LLaMA."""
    return mesh.get_group(MODEL_AXIS)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------
def unet_param_sharding_rules() -> Sequence[Tuple[str, Optional[int]]]:
    """The diffusion stack replicates every parameter (DDP); the batch
    carries the data axis. ``(pattern, dim)`` with ``dim`` None: replicated."""
    return ((".*", None),)


_COLUMN = r"(q_proj|k_proj|v_proj|gate_proj|up_proj)"
_ROW = r"(o_proj|down_proj)"


def llm_param_sharding_rules() -> Sequence[Tuple[str, Optional[int]]]:
    """Megatron tensor parallelism of the LLaMA over the model axis, as
    ``(pattern, dim)`` over the port's state-dict names (first match wins;
    ``dim`` None: replicated).

    Column-parallel q/k/v and gate/up shard their output features,
    row-parallel o and down their input features; the embeddings and
    ``lm_head`` shard the vocabulary. A dense ``weight`` is torch's
    ``[out, in]`` (column: dim 0, row: dim 1); int8's ``kernel_q`` keeps
    JAX's ``[in, out]``, int4's packed ``[in, F'/2]`` (its column cut is a
    repack, ``ops/int4_matmul.py::shard_int4_columns``). A scale shards on
    its feature axis (-1) in a column layer and on the rows of int4's
    ``[in/g, F']`` (-2) in a row layer; int8's 1-D per-channel scale has no
    dim -2, so a row layer replicates it. LoRA follows its base: A
    replicated and B on the output in a column layer, A on the input and B
    replicated in a row layer.

    The JAX rules (``diffsensei_tpu/parallel/mesh.py:76``) intend the same
    but match only the int8 kernels: their ``(q_proj|...)\\.kernel`` never
    meets the real ``q_proj.base.kernel``, so they replicate every bf16
    projection and adapter, and their 1-D ``kernel_scale`` rule puts the
    model axis on int4's group rows. A placement does not change JAX's
    values; the port computes each rank's part, so its table must be right
    on its own (``tests/test_torch_port_tensor_parallel.py`` lists the names
    where the two differ)."""
    return (
        (rf".*{_COLUMN}\.base\.weight", 0),
        (rf".*{_COLUMN}\.base\.kernel_q", 1),
        (rf".*{_COLUMN}\.base\.kernel_scale", -1),
        (rf".*{_COLUMN}\.lora_B\.weight", 0),
        (rf".*{_ROW}\.base\.weight", 1),
        (rf".*{_ROW}\.base\.kernel_q", 0),
        (rf".*{_ROW}\.base\.kernel_scale", -2),
        (rf".*{_ROW}\.lora_A\.weight", 1),
        (r"embed_tokens\.weight", 0),
        (r"lm_head\.weight", 0),
        (r"lm_head\.kernel_q", 1),
        (r"lm_head\.kernel_scale", -1),
        (r".*", None),
    )


def sharded_dim(name: str, ndim: int,
                rules: Sequence[Tuple[str, Optional[int]]]) -> Optional[int]:
    """The dimension of an ``ndim``-dimensional tensor ``name`` that the
    first matching rule shards (negative dims counted from the end), or
    None: replicated, also where the rule's dim does not exist."""
    for pattern, dim in rules:
        if re.fullmatch(pattern, name):
            if dim is None or not -ndim <= dim < ndim:
                return None
            return dim % ndim
    return None


# Leaves smaller than this replicate: sharding norm scales and biases buys
# no memory and costs an all-gather each. 64 KiB = a [128, 128] fp32 kernel.
FSDP_MIN_SIZE = 65536


def fsdp_spec(shape: Tuple[int, ...], num_shards: int,
              min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The dimension of ``shape`` to shard over ``num_shards`` ranks: the
    largest one they divide (the first of equals); None (replicated) when
    the leaf has fewer than ``min_size`` elements or no dimension divides.
    The JAX ``fsdp_spec`` answers with the same dimension as a
    ``PartitionSpec``."""
    size = 1
    for d in shape:
        size *= d
    if size < min_size or not shape:
        return None
    for dim in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[dim] % num_shards == 0 and shape[dim] >= num_shards:
            return dim
    return None


# ---------------------------------------------------------------------------
# this rank's rows
# ---------------------------------------------------------------------------
def shard_batch(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """This rank's contiguous block of rows of every leaf (the JAX
    ``shard_batch``'s ``P("data")`` placement); the row count must divide."""
    out = {}
    for k, x in batch.items():
        n = x.shape[0]
        if n % world:
            raise ValueError(f"{k}: {n} rows do not split over {world} ranks")
        out[k] = x[rank * (n // world):(rank + 1) * (n // world)]
    return out


def host_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rows ``[rank::world]`` of a global batch: the rows the bucket
    dataset gives this rank (``batches(host_id=rank, num_hosts=world)``)."""
    return x[rank::world]
