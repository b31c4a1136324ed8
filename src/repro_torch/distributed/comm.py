"""The collectives the ``moe_a2a`` schedule differentiates through, each an
autograd function whose backward is the forward's exact adjoint, so the
gradients of every rank's loss add up to those of the sum of the losses:

* :func:`all_to_all` — equal chunks of dim 0 to every rank of the group,
  concatenated on dim 0 in rank order (``lax.all_to_all``, tiled); its
  adjoint is the same exchange of the gradient.
* :func:`all_reduce_sum` — the sum over the group (``lax.psum``); its
  adjoint sums the gradients.
* :func:`all_gather` — every rank's tensor concatenated on dim 0 in rank
  order; its adjoint is a reduce-scatter, here the all-reduced gradient's
  own chunk (gloo has no reduce-scatter).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, dim=0)[dist.get_rank(ctx.group)], None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of ``x``'s dim 0 to rank i; the result holds rank j's chunk
    for this rank at position j.  Runs at every group size, 1 included."""
    return _AllToAll.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    return _AllGather.apply(x, group)
