"""The collectives of the parallel layer, with the gradients of ``shard_map``.

Each rank runs its block of the program (SPMD over ``torch.distributed``),
as ``shard_map`` runs its body once per device. Under ``shard_map`` the
transposes of the collectives give every rank's inputs the gradient of the
one global loss; ``torch.distributed.nn.functional.all_reduce`` does not
(it all-reduces in backward too, so ``n`` ranks that hold the same
replicated loss get ``n`` times the gradient). These functions follow the
global-loss convention instead:

* :func:`psum` all-reduces a partial result that comes out replicated over
  the group; its backward passes each rank's (replicated) cotangent
  through.
* :func:`replicated` marks an input that is replicated over a group while
  the result it feeds is sharded over that group (a table shard replicated
  over ``data`` under a data-sharded batch; the weights, replicated over
  ``model``, of a lookup whose partials are summed over ``model``): identity
  forward, the gradient summed over the group backward.
* :func:`all_to_all` (``lax.all_to_all(tiled=True)`` over dim 0) is its own
  transpose; :func:`all_gather` (``lax.all_gather(tiled=True)``) takes this
  rank's slice of the replicated cotangent.

The tensors go to the collective on their own device: NCCL on the card,
gloo on the CPU (and, staging through the host itself, on the card).
:func:`any_across` makes a flag global (an all-reduce of the max) and reads
it on the host, once; every rank of the group must call it, as every shard
takes the same ``lax.cond`` branch in the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        x = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None


def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        dist.all_to_all_single(out, x, group=group)
    return out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, replicated on every rank."""
    return _Psum.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; in backward, its gradient summed over the group."""
    return _Replicated.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of dim 0 goes to group rank ``j``, and block ``j`` of the
    result came from group rank ``j`` (dim 0 divides by the group size)."""
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    return _AllGather.apply(x, group, dim)


def any_across(flag: torch.Tensor, group) -> bool:
    """Whether ``flag`` (a bool scalar) holds on any rank of the group."""
    f = flag.reshape(1).to(torch.int32)
    dist.all_reduce(f, op=dist.ReduceOp.MAX, group=group)
    return bool(f.item())
