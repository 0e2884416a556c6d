"""The collectives of data-parallel training over a ``Mesh``.

Every rank joins the same collectives in the same order: the forward
pass's batch moments and valid counts as the model runs, their backward
counterparts as autograd replays the same graph, then one gradient
all-reduce.  On a mesh of one (or ``mesh=None``) each function here is the
identity and launches nothing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from multilingual_text_to_speech_tpu_torch.parallel.mesh import Mesh


def single(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.size == 1


class _AllSum(torch.autograd.Function):
    """All-reduce SUM whose backward all-reduces the cotangent (every
    rank's sum feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllSum.apply(g, ctx.group), None


def all_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the cotangent of
    the sum is summed over the ranks in turn (the batch statistics' path
    back to every rank's rows)."""
    if single(mesh):
        return x
    return _AllSum.apply(x, mesh.group)


@torch.no_grad()
def total(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, outside autograd (counts, logged
    values)."""
    if single(mesh):
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.group)
    return x


@torch.no_grad()
def all_reduce_gradients(params: Sequence[torch.Tensor],
                         mesh: Optional[Mesh]) -> None:
    """Sum every parameter's float32 gradient over the ranks in one flat
    buffer (JAX's psum of the replicated parameters' cotangents), a zero
    standing in for a rank's missing gradient.  The buffer carries one flag
    a parameter: a parameter no rank gave a gradient keeps none, as on a
    single device, where Adam skips it."""
    if single(mesh):
        return
    params = list(params)
    dev = params[0].device
    parts: List[torch.Tensor] = [
        (p.grad.reshape(-1) if p.grad is not None
         else torch.zeros(p.numel(), device=dev)) for p in params]
    parts.append(torch.tensor([float(p.grad is not None) for p in params],
                              device=dev))
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=mesh.group)
    has = flat[-len(params):].tolist()
    offset = 0
    for p, h in zip(params, has):
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p) if h else None
        offset += n


@torch.no_grad()
def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh],
                    batch: int) -> torch.Tensor:
    """The global batch's rows of a per-rank output ``x`` (JAX
    ``process_allgather(..., tiled=True)``), on every rank: the ranks'
    rows in rank order, each data shard once where its ``model`` ranks
    share it (``Mesh.shard_rows`` of a global batch of ``batch`` rows)."""
    if single(mesh):
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    if batch % mesh.size:
        parts = parts[::mesh.model]
    return torch.cat(parts)


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: Optional[Mesh]
              ) -> torch.nn.Module:
    """Rank 0's weights and buffers on every rank (JAX ``replicate``):
    broadcast, then each tensor's float64 sum held equal across the ranks
    (a raise otherwise)."""
    if single(mesh):
        return model
    tensors = [*model.parameters(), *model.buffers()]
    for t in tensors:
        dist.broadcast(t.data, src=0, group=mesh.group)
    sums = torch.stack([t.double().sum() for t in tensors])
    lo, hi = sums.clone(), sums.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    if not torch.equal(lo, hi):
        raise RuntimeError("the ranks' weights differ after the broadcast")
    return model


def barrier(mesh: Optional[Mesh]) -> None:
    if not single(mesh):
        dist.barrier(group=mesh.group)
