"""Logical-axis sharding rules (the port of ``repro.distributed.sharding``).

Model code names every parameter dimension by a *logical* axis ("embed",
"ff", "vocab", "expert", ...); this module maps logical names to mesh axes
per architecture, exactly as the JAX module does:

* **TP** ("model" axis): attention head projections, MLP hidden, vocab.
* **EP** ("data" axis): the MoE expert dim; under ``moe_2d_ep``, or
  ``moe_a2a`` with padded storage, over ("data", "model").
* **FSDP** (("pod", "data")): the ``embed`` dim of weight matrices for the
  archs in :data:`FSDP_ARCHS`.
* **ZeRO-1**: optimizer-state leaves additionally shard their largest
  still-replicated divisible dim over ("pod", "data").

``jax.sharding.NamedSharding`` has no counterpart here, so a *spec* is a
tuple of the entries the JAX module's ``PartitionSpec`` holds (None, an
axis name, or a tuple of names) and :func:`shardings_for` returns a tree of
them.  :func:`local_shard` and :func:`gather_shard` realise a spec
on a rank: the rank's slice of a whole tensor, and the whole tensor back
from every rank's slice; a :class:`Layout` holds a state tree's specs,
and the leaves a layer gathers whole before use (FSDP).  Which spec each
leaf takes is :mod:`repro_torch.launch.specs`'s business.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.config import ModelConfig

PyTree = Any
MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

# archs whose parameter memory requires FSDP over the batch axes
FSDP_ARCHS = ("kimi-k2-1t-a32b", "llama4-scout-17b-a16e", "chameleon-34b")


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def rules_for(cfg: ModelConfig, mesh) -> Dict[str, MeshAxes]:
    """Logical-axis -> mesh-axes mapping for this arch on this mesh."""
    batch = batch_axes(mesh)
    fsdp = cfg.name in FSDP_ARCHS
    rules: Dict[str, MeshAxes] = {
        "layers": None,
        "embed": batch if fsdp else None,
        "q_proj": "model",
        "kv_proj": "model",
        "heads": "model",
        "kv_heads": "model",
        "kv_hd": "model",      # cache head_dim fallback ('kv_cache_hd' flag)
        "ff": "model",
        "vocab": "model",
        "ssm_inner": "model",
        "ssm_bc": "model",
        "ssm_heads": "model",
        # MoE: EP over the data axis; expert-ff TP over model.  With the
        # 'moe_2d_ep' flag (or 'moe_a2a' with padded storage), experts
        # shard over (data x model).
        "expert": (("data", "model")
                   if ("moe_2d_ep" in cfg.perf_flags
                       or ("moe_a2a" in cfg.perf_flags and cfg.moe
                           and cfg.moe.num_experts >= 256))
                   and "data" in mesh.axis_names
                   else "data" if "data" in mesh.axis_names else None),
        "moe_dmodel": "model",   # dispatched-tensor d_model (RS not AR)
        # activations
        "batch": batch,
        "moe_groups": batch,
        "seq": None,
    }
    return rules


def spec_for(axes: Sequence[Optional[str]], rules: Mapping[str, MeshAxes],
             shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """Spec from logical axes, with the JAX module's two safety rails: a
    dim that does not divide by its mesh axes stays replicated (when a
    mesh is current and ``shape`` given), and a mesh axis goes to at most
    one dim, left to right."""
    entries = []
    used: set = set()
    mesh = current_mesh()
    for i, ax in enumerate(axes):
        m = rules.get(ax) if ax is not None else None
        if m is None:
            entries.append(None)
            continue
        axes_tuple = (m,) if isinstance(m, str) else tuple(m)
        axes_tuple = tuple(a for a in axes_tuple if a not in used)
        if not axes_tuple:
            entries.append(None)
            continue
        if shape is not None and mesh is not None:
            prod = int(np.prod([mesh.shape[a] for a in axes_tuple]))
            if shape[i] % prod != 0:
                entries.append(None)
                continue
        used.update(axes_tuple)
        entries.append(axes_tuple if len(axes_tuple) > 1 else axes_tuple[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def tree_map_axes(fn, axes_tree: PyTree, *trees: PyTree) -> PyTree:
    """``fn(axes, *leaves)`` over a tree whose leaves are tuples (logical
    axes or specs), with the other trees' leaves at the same paths."""
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, axes_tree[k], *(t[k] for t in trees))
                for k in axes_tree}
    return fn(axes_tree, *trees)


def shardings_for(axes_tree: PyTree, params_tree: PyTree, mesh,
                  rules: Mapping[str, MeshAxes]) -> PyTree:
    """Spec tree matching ``params_tree`` from logical axes."""
    def one(axes, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        return spec_for(tuple(axes), rules, shape)
    return tree_map_axes(one, axes_tree, params_tree)


def zero1_shardings(param_specs: PyTree, params_tree: PyTree, mesh
                    ) -> PyTree:
    """Optimizer-state specs: each parameter's spec with its largest
    still-replicated dim divisible by the batch axes sharded over them."""
    batch = batch_axes(mesh)
    if not batch:
        return param_specs
    denom = int(np.prod([mesh.shape[a] for a in batch]))

    def one(spec: Spec, leaf):
        spec = list(spec) + [None] * (leaf.ndim - len(spec))
        best, best_size = None, 0
        for i, (entry, size) in enumerate(zip(spec, leaf.shape)):
            if entry is None and size % denom == 0 and size > best_size:
                best, best_size = i, size
        if best is not None:
            spec[best] = batch if len(batch) > 1 else batch[0]
        return tuple(spec)

    return tree_map_axes(one, param_specs, params_tree)


# ---------------------------------------------------------------------------
# Current-mesh registry
# ---------------------------------------------------------------------------

_CURRENT: Dict[str, Any] = {"mesh": None, "rules": None, "layout": None}


class use_mesh_rules:
    """Context manager installing (mesh, rules[, layout]): the model reads
    the mesh to take the ``moe_a2a`` schedule and its ``model`` group, and
    the parameters' :class:`Layout` to gather its FSDP leaves."""

    def __init__(self, mesh, rules: Optional[Mapping] = None,
                 layout: Optional["Layout"] = None):
        self.mesh, self.rules, self.layout = mesh, rules, layout
        self._saved = None

    def __enter__(self):
        self._saved = dict(_CURRENT)
        _CURRENT["mesh"] = self.mesh
        _CURRENT["rules"] = self.rules
        _CURRENT["layout"] = self.layout
        return self

    def __exit__(self, *exc):
        _CURRENT.update(self._saved)
        return False


def current_mesh():
    return _CURRENT["mesh"]


def current_rules() -> Optional[Mapping[str, MeshAxes]]:
    return _CURRENT["rules"]


def current_layout() -> Optional["Layout"]:
    return _CURRENT["layout"]


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """The identity.  In the JAX package this is a layout hint to GSPMD
    (``with_sharding_constraint``); the port has no compiler that
    partitions a program, so a hint has nothing to act on: every layout
    the port runs is realised by hand (:func:`local_shard`, the model's
    tensor-parallel layers, :func:`gather_for_use`)."""
    return x


# ---------------------------------------------------------------------------
# Realising a spec on a rank
# ---------------------------------------------------------------------------

def entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's part of a leaf of ``shape`` under ``spec``
    (a dim that does not divide is padded up, as :func:`local_shard`
    pads it)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = mesh.axis_size(entry_axes(entry))
        out[dim] = -(-out[dim] // n)
    return tuple(out)


def local_shard(x: torch.Tensor, spec: Spec, mesh,
                rank: Optional[int] = None) -> torch.Tensor:
    """``rank``'s (this rank's) part of the whole tensor ``x`` under
    ``spec``: along each sharded dim, the chunk at the rank's row-major
    index over the entry's axes.  A dim that does not divide is padded
    with zeros to the next multiple first (the ``moe_a2a`` schedule's
    padded experts).  A contiguous copy, or ``x`` itself where the spec
    splits nothing (every entry's axes of size 1)."""
    if all(mesh.axis_size(entry_axes(e)) == 1 for e in spec):
        return x
    out = x
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = mesh.axis_size(axes)
        size = out.shape[dim]
        per = -(-size // n)
        if per * n != size:
            pad = list(out.shape)
            pad[dim] = per * n - size
            out = torch.cat([out, out.new_zeros(pad)], dim=dim)
        out = out.narrow(dim, mesh.axis_index(axes, rank) * per, per)
    return out.contiguous()


def gather_shard(x: torch.Tensor, spec: Spec, mesh,
                 shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The inverse of :func:`local_shard`, collective over the ranks of
    each sharded dim's axes: every rank's part gathered into the whole,
    cut back to ``shape`` where :func:`local_shard` padded."""
    out = x.contiguous()
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes or mesh.axis_size(axes) == 1:
            continue
        parts = [torch.empty_like(out) for _ in range(mesh.axis_size(axes))]
        dist.all_gather(parts, out, group=mesh.group(axes))
        out = torch.cat(parts, dim=dim)
    if shape is not None:
        for dim, size in enumerate(shape):
            if out.shape[dim] != size:
                out = out.narrow(dim, 0, size)
        out = out.contiguous()
    return out


def gather_to(x: torch.Tensor, spec: Spec, mesh, shape: Sequence[int],
              dst: int = 0) -> Optional[torch.Tensor]:
    """The whole tensor on rank ``dst`` (None on the others) from every
    rank's part under ``spec``: one ``gather`` over the mesh's ranks, each
    part put at its block, cut back to ``shape`` where
    :func:`local_shard` padded.  Only ``dst`` holds more than its part."""
    x = x.contiguous()
    parts = ([torch.empty_like(x) for _ in range(mesh.size)]
             if mesh.rank == dst else None)
    dist.gather(x, parts, dst=dst, group=mesh.world)
    if parts is None:
        return None
    out = x.new_empty([n * mesh.axis_size(entry_axes(spec[d]))
                       if d < len(spec) else n
                       for d, n in enumerate(x.shape)])
    for r, part in enumerate(parts):
        view = out
        for d, entry in enumerate(spec):
            i = mesh.axis_index(entry_axes(entry), r)
            view = view.narrow(d, i * x.shape[d], x.shape[d])
        view.copy_(part)
    for d, n in enumerate(shape):
        if out.shape[d] != n:
            out = out.narrow(d, 0, n)
    return out.contiguous()


def tree_items(tree: PyTree, path: Tuple = ()):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, in
    ``jax.tree_util``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def tree_rebuild(tree: PyTree, fn, path: Tuple = ()) -> PyTree:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_rebuild(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


class Layout:
    """How a state tree lies on a mesh: the spec, the whole shape and the
    element size of each leaf, by its path (:func:`tree_items`), and for
    each leaf a layer gathers whole before use (FSDP) the dims it gathers
    and their axes (``gathered``)."""

    def __init__(self, mesh, specs: Dict[Tuple, Spec],
                 shapes: Dict[Tuple, Tuple[int, ...]],
                 itemsizes: Optional[Dict[Tuple, int]] = None,
                 gathered: Optional[Dict[Tuple, Tuple]] = None):
        self.mesh, self.specs, self.shapes = mesh, specs, shapes
        self.itemsizes = itemsizes or {}
        self.gathered = gathered or {}

    def spec(self, path: Tuple) -> Spec:
        return self.specs[path]

    def part(self, i: int) -> "Layout":
        """The layout of element ``i`` of a tuple tree, its paths without
        the index."""
        def sub(d):
            return {p[1:]: v for p, v in d.items() if p[0] == i}
        return Layout(self.mesh, sub(self.specs), sub(self.shapes),
                      sub(self.itemsizes), sub(self.gathered))

    def shard_shape(self, path: Tuple) -> Tuple[int, ...]:
        return shard_shape(self.shapes[path], self.specs[path], self.mesh)

    def rank_bytes(self) -> int:
        """The bytes each rank holds: every leaf's part (the parts of one
        leaf have one shape on every rank)."""
        return sum(int(np.prod(self.shard_shape(p))) * self.itemsizes[p]
                   for p in self.specs)

    def sharded(self, path: Tuple) -> bool:
        return any(self.mesh.axis_size(entry_axes(e)) > 1
                   for e in self.specs[path])

    def shard(self, tree: PyTree) -> PyTree:
        """This rank's parts of a whole tree."""
        return tree_rebuild(tree, lambda path, x: local_shard(
            x, self.specs[path], self.mesh))

    def gather_leaf(self, path: Tuple, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's part (collective)."""
        return gather_shard(x, self.specs[path], self.mesh,
                            self.shapes[path])

    def gather_leaf_to(self, path: Tuple, x: torch.Tensor,
                       dst: int = 0) -> Optional[torch.Tensor]:
        """The whole leaf on rank ``dst``, None on the others
        (collective)."""
        return gather_to(x, self.specs[path], self.mesh, self.shapes[path],
                         dst)

    def gather(self, tree: PyTree) -> PyTree:
        """The whole tree from every rank's parts (collective)."""
        return tree_rebuild(tree, self.gather_leaf)

    def zeros(self, tree: PyTree, device) -> PyTree:
        """This rank's parts of a tree of zeros with ``tree``'s leaves'
        whole shapes and types (``tree`` on ``meta``: an optimizer's
        initial state)."""
        return tree_rebuild(tree, lambda path, x: torch.zeros(
            self.shard_shape(path), dtype=x.dtype, device=device))


def gather_for_use(tree: PyTree, layout: Layout, prefix: Tuple = (),
                   lead: int = 0) -> PyTree:
    """``tree`` (the subtree of the parameters at ``prefix``; with
    ``lead`` leading dims dropped from its leaves: a layer's views of the
    stacked leaves) with each FSDP leaf gathered whole along its
    batch-axis entries (:func:`~repro_torch.distributed.comm.gather`, whose
    backward reduce-scatters the gradient); the other leaves as they
    are."""
    from .comm import gather

    def one(path, x):
        for dim, axes in layout.gathered.get(prefix + path, ()):
            x = gather(x, dim - lead, layout.mesh.group(axes))
        return x
    return tree_rebuild(tree, one)
