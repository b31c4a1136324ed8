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
tensor itself.  :func:`all_reduce_` is the in-place all-reduce (a sum or a
max) of the steps' gradients, norms and metrics.

**The record.**  Under :func:`recording` every collective of this module,
in both directions of autograd, appends a :class:`Collective` to a list:
the logical op (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``; gloo's stand-in for a reduce-scatter, an all-reduce and a
chunk, counts as the reduce-scatter NCCL runs), the call site (the first
frame of the package outside this module, "(backward)" added for an
adjoint), the bytes
and type of the result on the rank (the result shape's bytes, as
``repro.launch.hlo_analysis`` reads an HLO op) and the group's size.
Under the record a group of an abstract mesh
(:meth:`~repro_torch.launch.mesh.Mesh.group`) is an :class:`AbstractGroup`:
a collective over it returns an uninitialised tensor of the result's shape
and type, reads nothing and communicates nothing, so a rank's step runs
on the ``meta`` device (``launch/dryrun.py``).  Outside the record nothing
changes: the same calls, the same bits.
"""
from __future__ import annotations

import contextlib
import os
import sys
from dataclasses import dataclass
from typing import Iterator, List, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Collective:
    """One collective a rank ran: ``nbytes`` of the result on the rank."""

    op: str
    site: str
    nbytes: int
    dtype: str
    group: int


@dataclass(frozen=True)
class AbstractGroup:
    """A group of an abstract mesh under :func:`recording`: its size and
    the rank's index in it, no processes."""

    size: int
    rank: int


_RECORD: Optional[List[Collective]] = None
_HERE = os.path.abspath(__file__)
_PACKAGE = os.path.dirname(os.path.dirname(_HERE))


@contextlib.contextmanager
def recording() -> Iterator[List[Collective]]:
    """Record every collective of this module while the context is
    active; yields the list the entries go to."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def is_recording() -> bool:
    return _RECORD is not None


def _site() -> str:
    """``path:line (function)`` of the first frame of the package outside
    this module (torch's own frames, autograd's ``apply``, skipped), the
    path from the package's parent."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path != _HERE and path.startswith(_PACKAGE + os.sep):
            rel = os.path.relpath(path, os.path.dirname(_PACKAGE))
            return f"{rel}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "?"


def _note(op: str, out: torch.Tensor, group, site: Optional[str] = None
          ) -> None:
    if _RECORD is not None:
        _RECORD.append(Collective(op, site or _site(),
                                  out.numel() * out.element_size(),
                                  str(out.dtype).replace("torch.", ""),
                                  _size(group)))


def _abstract(group) -> bool:
    return isinstance(group, AbstractGroup)


def _rank(group) -> int:
    return group.rank if _abstract(group) else dist.get_rank(group)


def _all_to_all(x: torch.Tensor, group, site: str) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    if not _abstract(group):
        dist.all_to_all_single(out, x, group=group)
    _note("all-to-all", out, group, site)
    return out


def _all_reduce(x: torch.Tensor, group, site: str) -> torch.Tensor:
    """The sum of ``x`` (a new contiguous tensor) over ``group``."""
    out = x.clone(memory_format=torch.contiguous_format)
    if not _abstract(group):
        dist.all_reduce(out, group=group)
    _note("all-reduce", out, group, site)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.site = group, _site() if is_recording() else ""
        return _all_to_all(x, group, ctx.site)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.site + " (backward)"), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.site = group, _site() if is_recording() else ""
        return _all_reduce(x, group, ctx.site)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.site + " (backward)"), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.site = group, _site() if is_recording() else ""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(_size(group))]
        if not _abstract(group):
            dist.all_gather(parts, x, group=group)
        out = torch.cat(parts, dim=0)
        _note("all-gather", out, group, ctx.site)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        if not _abstract(ctx.group):
            dist.all_reduce(g, group=ctx.group)
        n = _size(ctx.group)
        out = g.chunk(n, dim=0)[_rank(ctx.group)]
        _note("reduce-scatter", out, ctx.group, ctx.site + " (backward)")
        return out, None


def _size(group) -> int:
    return group.size if _abstract(group) else dist.get_world_size(group)


def _nccl(group) -> bool:
    return not _abstract(group) and dist.get_backend(group) == "nccl"


def reduce_scatter(x: torch.Tensor, dim: int, group,
                   site: Optional[str] = None) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, this rank's chunk of
    it along ``dim`` (a contiguous tensor; ``x`` itself at one rank)."""
    n = _size(group)
    if n == 1:
        return x
    site = site or (_site() if is_recording() else "")
    dim = dim % x.dim()
    if _nccl(group):
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        out = out.movedim(0, dim).contiguous()
    else:
        x = x.clone(memory_format=torch.contiguous_format)
        if not _abstract(group):
            dist.all_reduce(x, group=group)
        out = x.chunk(n, dim=dim)[_rank(group)].contiguous()
    _note("reduce-scatter", out, group, site)
    return out


def gather_along(x: torch.Tensor, dim: int, group,
                 site: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``x`` over ``group`` concatenated along ``dim`` in
    rank order (no autograd; ``x`` itself at one rank)."""
    n = _size(group)
    if n == 1:
        return x
    site = site or (_site() if is_recording() else "")
    dim = dim % x.dim()
    x = x.contiguous()
    if _nccl(group) and dim == 0:
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        if not _abstract(group):
            dist.all_gather(parts, x, group=group)
        out = torch.cat(parts, dim=dim)
    _note("all-gather", out, group, site)
    return out


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` all-reduced in place over ``group`` (``op`` "sum" or "max";
    no autograd): the steps' gradients, norms and metrics."""
    if not _abstract(group):
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
    _note("all-reduce", t, group)
    return t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.site = _site() if is_recording() else ""
        return gather_along(x, dim, group, ctx.site)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group,
                              ctx.site + " (backward)"), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.site = _site() if is_recording() else ""
        return reduce_scatter(x, dim, group, ctx.site)

    @staticmethod
    def backward(ctx, g):
        return gather_along(g, ctx.dim, ctx.group,
                            ctx.site + " (backward)"), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.site = group, _site() if is_recording() else ""
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.site + " (backward)"), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, _site() if is_recording() else "")

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
