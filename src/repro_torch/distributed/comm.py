"""The collectives the model differentiates through, each an autograd
function whose backward is the forward's exact adjoint.

Ranks whose losses add (data parallelism, the ``moe_a2a`` schedule), so
that the gradients of every rank's loss add up to those of the sum of the
losses:

* :func:`all_to_all` — equal chunks of dim 0 to every rank of the group,
  concatenated on dim 0 in rank order (``lax.all_to_all``, tiled); its
  adjoint is the same exchange of the gradient.
* :func:`all_reduce_sum` — the sum over the group (``lax.psum``); its
  adjoint sums the gradients.
* :func:`all_gather` — every rank's tensor concatenated on dim 0 in rank
  order; its adjoint is a reduce-scatter, here the all-reduced gradient's
  own chunk (gloo has no reduce-scatter).
* :func:`gather` — the same along any dim, for FSDP's gather of a leaf's
  shards over the batch axes (each rank's rows use the whole leaf): its
  adjoint is a reduce-scatter along that dim (``reduce_scatter_tensor``
  on NCCL; gloo has none and keeps an all-reduce and a chunk, the same
  sums).
* :func:`scatter_sum` — the sum over the group, this rank's chunk of it
  along a dim (the dense MoE layer's partial outputs back to each rank's
  rows); its adjoint gathers the chunks' gradients.

Ranks along ``model`` compute one loss together (tensor parallelism, the
Megatron pair): a tensor replicated over them is one value, so

* :func:`copy_to` — the identity, at the input of the rank's part of a
  computation (a column-parallel projection's); its backward all-reduces
  the ranks' partial gradients;
* :func:`reduce_from` — the all-reduce of the ranks' partial results (a
  row-parallel projection's output); its backward is the identity.

Over a group of one rank :func:`gather`, :func:`reduce_scatter`,
:func:`scatter_sum`, :func:`copy_to` and :func:`reduce_from` return the
tensor itself.
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


def _size(group) -> int:
    return dist.get_world_size(group)


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, this rank's chunk of
    it along ``dim`` (a contiguous tensor; ``x`` itself at one rank)."""
    n = _size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    if _nccl(group):
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


def gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` over ``group`` concatenated along ``dim`` in
    rank order (no autograd; ``x`` itself at one rank)."""
    n = _size(group)
    if n == 1:
        return x
    dim = dim % x.dim()
    if _nccl(group) and dim == 0:
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_along(g, ctx.dim, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; the backward
    reduce-scatters along it."""
    return x if _size(group) == 1 else _Gather.apply(x, dim, group)


def scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of every rank's ``x``;
    the backward gathers the gradient along it."""
    return x if _size(group) == 1 else _ScatterSum.apply(x, dim, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x``; the backward all-reduces the gradient over ``group``."""
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``; the backward is the
    identity."""
    return x if _size(group) == 1 else _ReduceFrom.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of ``x``'s dim 0 to rank i; the result holds rank j's chunk
    for this rank at position j.  Runs at every group size, 1 included."""
    return _AllToAll.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    return _AllGather.apply(x, group)
