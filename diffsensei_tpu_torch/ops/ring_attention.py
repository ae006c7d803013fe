"""Ring attention: exact self-attention with the sequence sharded over the
ranks of a process group (port of ``diffsensei_tpu/ops/ring_attention.py``).

Each rank holds a block of Q, K and V along the sequence. For ``n`` ranks it
attends its Q block to the K/V block it holds, passes that block on to rank
``(r + 1) % n`` and takes the next from ``(r - 1) % n`` (the JAX
``ppermute`` ring), ``n - 1`` times, and merges the partial results by their
log-sum-exp. No rank ever holds the ``S x S`` scores. Forward only: the
serving path for 2048²-class panels, whose level-1 self-attention has 16384
tokens.

A chunk's attention is kernel B1's ``(o, lse)`` on the card (bf16, a
head_dim B1 takes) whatever the chunk's length, as the JAX path calls its
Pallas kernel; elsewhere the plain twin of the JAX ``_chunk_attention_ref``.
The next block's transfer (``batch_isend_irecv``) runs while this block's
chunk computes. ``ring_schedule`` runs the ``n`` ranks' chunks and merges in
one process, to hold the ring's arithmetic where there is only one card
(NCCL refuses two ranks on it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from diffsensei_tpu_torch.ops import flash_attention as fa


def uses_kernel(q: torch.Tensor) -> bool:
    """True where a chunk runs on kernel B1."""
    return q.is_cuda and q.dtype == torch.bfloat16 and q.shape[-1] in fa.HEAD_DIMS


def chunk_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``(o fp32 [B, H, Sq, D], lse [B, H, Sq])`` of one chunk, the JAX
    ``_chunk_attention_ref``: fp32 scores, unnormalized probabilities cast to
    v's dtype for the product, then divided by their sum."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o / l, (m + torch.log(l))[..., 0]


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o fp32, lse)`` of q against one K/V chunk: B1 on the card, the
    plain twin elsewhere."""
    if uses_kernel(q):
        o, lse = fa.flash_attention(q, k, v, sm_scale=sm_scale)
        return o.float(), lse
    return chunk_attention_ref(q, k, v, sm_scale)


def merge_partials(o_acc: torch.Tensor, lse_acc: torch.Tensor, o_new: torch.Tensor,
                   lse_new: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The log-sum-exp merge of two normalized partials (the JAX ring's
    ``body``)."""
    lse_max = torch.maximum(lse_acc, lse_new)
    w_acc = torch.exp(lse_acc - lse_max)[..., None]
    w_new = torch.exp(lse_new - lse_max)[..., None]
    o = (o_acc * w_acc + o_new * w_new) / (w_acc + w_new)
    lse = lse_max + torch.log(torch.exp(lse_acc - lse_max) + torch.exp(lse_new - lse_max))
    return o, lse


def _rotate(kc: torch.Tensor, vc: torch.Tensor, group: dist.ProcessGroup):
    """Start sending ``(kc, vc)`` to the next rank and receiving the previous
    rank's; returns the receive buffers and the requests."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prev = dist.get_global_rank(group, (r - 1) % n)
    k_in, v_in = torch.empty_like(kc), torch.empty_like(vc)
    ops = [dist.P2POp(dist.isend, kc, nxt, group), dist.P2POp(dist.isend, vc, nxt, group),
           dist.P2POp(dist.irecv, k_in, prev, group), dist.P2POp(dist.irecv, v_in, prev, group)]
    return k_in, v_in, dist.batch_isend_irecv(ops)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group: dist.ProcessGroup,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact non-causal attention with the sequence sharded over ``group``:
    this rank's blocks ``[B, H, S_local, D]`` in, its output block out (in
    q's dtype)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    n = dist.get_world_size(group)
    kc, vc = (k, v) if n == 1 else (k.contiguous(), v.contiguous())   # sends need contiguous
    o = lse = None
    for step in range(n):
        pending = _rotate(kc, vc, group) if step < n - 1 else None
        o_new, lse_new = chunk_attention(q, kc, vc, sm_scale)
        o, lse = (o_new, lse_new) if o is None else merge_partials(o, lse, o_new, lse_new)
        if pending is not None:
            kc, vc, reqs = pending
            for req in reqs:
                req.wait()
    return o.to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           group: dist.ProcessGroup,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """The ring over full (replicated) ``[B, H, S, D]`` tensors: each rank
    takes its contiguous block of the sequence, runs the ring, and the
    blocks are all-gathered back into the full output (what ``shard_map``
    with ``P(None, None, axis, None)`` in and out gives inside the JAX
    package's replicated UNet). S must divide by the group's size."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    s = q.shape[2]
    if s % n:
        raise ValueError(f"a sequence of {s} does not split over {n} ranks")
    block = lambda t: t[:, :, r * (s // n):(r + 1) * (s // n)]
    out = ring_flash_attention(block(q), block(k), block(v), group, sm_scale).contiguous()
    if n == 1:
        return out
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out, group=group)
    return torch.cat(parts, dim=2)


def ring_schedule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n: int,
                  sm_scale: Optional[float] = None, return_lse: bool = False):
    """What ``ring_attention_sharded`` computes on ``n`` ranks, in one
    process: rank ``r`` attends its Q block to K/V blocks ``r, r - 1, ...``
    in the ring's order through ``chunk_attention`` and ``merge_partials``
    (``n²`` chunks), the blocks concatenated; with ``return_lse`` also the
    merged log-sum-exp ``[B, H, S]``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = q.shape[2]
    if s % n:
        raise ValueError(f"a sequence of {s} does not split over {n} ranks")
    block = lambda t, i: t[:, :, i * (s // n):(i + 1) * (s // n)]
    outs, lses = [], []
    for r in range(n):
        o = lse = None
        for step in range(n):
            j = (r - step) % n
            o_new, lse_new = chunk_attention(block(q, r), block(k, j).contiguous(),
                                             block(v, j).contiguous(), sm_scale)
            o, lse = (o_new, lse_new) if o is None else merge_partials(o, lse, o_new, lse_new)
        outs.append(o.to(q.dtype))
        lses.append(lse)
    o = torch.cat(outs, dim=2)
    return (o, torch.cat(lses, dim=2)) if return_lse else o
