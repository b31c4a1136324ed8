"""Meshes of ranks over ``torch.distributed`` (the port of
``repro.launch.mesh``).

A :class:`Mesh` names the axes of a grid of ranks, as ``jax.make_mesh``
names a grid of devices, in JAX's device order: rank r sits at the
row-major coordinate of r over the axes.  It holds one process group for
each axis and one for ``("data", "model")`` flattened (the expert
all-to-all's group); :meth:`Mesh.group` builds any other set of axes on
first use, and :attr:`Mesh.world` is the group of all of them.  An
abstract mesh (:func:`abstract_mesh`) has a shape and names and no
groups: the spec trees of :mod:`repro_torch.distributed.sharding` and
:mod:`repro_torch.launch.specs` are computed on it.

:func:`init_distributed` starts the process group: NCCL for the card,
gloo for the CPU, from torchrun's ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` or from a ``file://`` store.  The mesh functions are
functions, as in the JAX module, so importing this module starts nothing.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Axes = Tuple[str, ...]


class Mesh:
    """A grid of ranks with named axes; ``shape`` maps each name to its
    size in axis order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 abstract: bool = False, backend: Optional[str] = None):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             "in length or repeat a name")
        self.axis_names = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.size = int(np.prod(shape)) if shape else 1
        self.abstract = abstract
        self.backend = backend
        self._groups: Dict[Axes, object] = {}
        self._by_ranks: Dict[Tuple[int, ...], object] = {}
        self.rank = 0
        if abstract:
            return
        if not dist.is_initialized():
            raise RuntimeError("no process group: call init_distributed() "
                               "before building a mesh")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {dict(self.shape)} needs {self.size} "
                             f"ranks, the process group has {world}")
        self.rank = dist.get_rank()
        for ax in axes:
            self.group((ax,))
        a2a = tuple(a for a in ("data", "model") if a in axes)
        if len(a2a) > 1:
            self.group(a2a)

    def __repr__(self) -> str:
        kind = "AbstractMesh" if self.abstract else "Mesh"
        return f"{kind}({dict(self.shape)})"

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Each axis's coordinate of ``rank`` (this rank by default)."""
        r = self.rank if rank is None else rank
        idx = np.unravel_index(r, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def axis_index(self, axes: Sequence[str],
                   rank: Optional[int] = None) -> int:
        """The row-major index of ``rank`` over ``axes``, in their order
        (``jax.lax.axis_index`` of the tuple)."""
        c = self.coords(rank)
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def ranks_along(self, axes: Sequence[str],
                    rank: Optional[int] = None) -> list:
        """The ranks that share ``rank``'s coordinates off ``axes``,
        ordered by their index over ``axes``."""
        c = self.coords(rank)
        sizes = tuple(self.shape.values())
        out = []
        for i in range(self.axis_size(axes)):
            cc = dict(c)
            for a, v in zip(axes, np.unravel_index(
                    i, tuple(self.shape[a] for a in axes))):
                cc[a] = int(v)
            out.append(int(np.ravel_multi_index(
                tuple(cc[a] for a in self.axis_names), sizes)))
        return out

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes`` (their ranks in
        :meth:`ranks_along`'s order, which must be ascending: the axes in
        mesh order).  The first call for a set of axes is collective: every
        rank builds every group of the set, in one order.  Sets of axes
        over the same ranks share one group (on a mesh of one rank, all of
        them): NCCL gives each group a communicator and its buffers on the
        card."""
        axes = tuple(axes)
        if self.abstract:
            raise RuntimeError(f"{self!r} has no process groups")
        if axes not in self._groups:
            order = [self.axis_names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"group axes {axes} not in mesh order "
                                 f"{self.axis_names}")
            mine = None
            seen = set()
            for r in range(self.size):
                ranks = tuple(self.ranks_along(axes, r))
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = self._by_ranks.get(ranks)
                if g is None:
                    g = dist.new_group(list(ranks), backend=self.backend)
                    self._by_ranks[ranks] = g
                if self.rank in ranks:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    @property
    def world(self):
        """The group of every rank of the mesh."""
        return self.group(self.axis_names)


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A shape and names, no ranks or groups (JAX's ``AbstractMesh``)."""
    return Mesh(shape, axes, abstract=True)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              backend: Optional[str] = None) -> Mesh:
    """A mesh over the process group's ranks (elastic re-mesh and tests);
    its groups take ``backend`` (the default group's when None: gloo
    groups beside an NCCL default hold a CPU run)."""
    return Mesh(shape, axes, backend=backend)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks);
    raises on any other world size, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model: Optional[int] = None) -> Mesh:
    """(world // model, model) over ("data", "model")."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = model or 1
    return make_mesh((n // model, model), ("data", "model"))


def init_distributed(*, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Start the default process group and return (rank, world size).

    Under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
    rendezvous in the environment) it takes those; otherwise ``rank``,
    ``world_size`` and ``init_method`` (a ``file://`` store) must be
    given.  The backend is NCCL when a card is present, gloo otherwise;
    NCCL first makes ``cuda:LOCAL_RANK`` the current device."""
    if rank is None or world_size is None or init_method is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError("no torchrun environment: pass rank, "
                             "world_size and init_method")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
        init_method = init_method or "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return rank, world_size
