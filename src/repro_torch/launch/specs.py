"""Abstract state, its sharding specs, and the layout the port realises
(the port of ``repro.launch.specs``), with no allocation.

``abstract_state`` builds the training state (and the optimizer's) on
PyTorch's ``meta`` device: every leaf has the JAX tree's shape and type and
no storage, so a 1T-parameter config is sized on any host.

The sharding half is the JAX module's, over spec trees
(:mod:`repro_torch.distributed.sharding`) instead of ``NamedSharding``
trees: :func:`state_shardings` (parameters by their logical axes,
:func:`param_axes`; optimizer state by its parameter's spec, extended by
ZeRO-1), :func:`train_batch_specs`, :func:`cache_specs` and
:func:`default_microbatches`.  They equal the JAX specs leaf for leaf.

What the ranks hold (:func:`state_layout`) is the JAX layout itself:
each parameter by its spec (tensor parallelism over ``model``, FSDP of
``embed`` over the batch axes for :data:`~repro_torch.distributed.
sharding.FSDP_ARCHS`, a dense MoE layer's experts over ``data`` and their
``ff`` over ``model``), each optimizer-state leaf by its ZeRO-1 spec, the
batch's rows by :func:`train_batch_specs`.  The one exception is the
expert stacks of a ``moe_a2a`` config, held over the all-to-all's group
as the JAX schedule's ``shard_map`` takes them (:func:`expert_spec`).
:func:`rank_state` builds a rank's state leaf by leaf, never the whole
tree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..distributed import sharding as dist
from ..models.config import ModelConfig, ShapeConfig
from ..models.moe_a2a import a2a_active, a2a_axes
from ..models.transformer import (has_attn, has_mlp, has_ssm, init_cache,
                                  init_train_state)
from ..optim import Optimizer

PyTree = Any

PATCH_TOKENS = 256        # chameleon stub: VQ patches fused at the front


def abstract_state(cfg: ModelConfig, optimizer: Optional[Optimizer] = None
                   ) -> Tuple[PyTree, Optional[PyTree]]:
    """(params, opt_state) on the ``meta`` device: shapes and types only,
    zero allocation (``opt_state`` None without an optimizer)."""
    params = init_train_state(cfg, device="meta")
    return params, (optimizer.init(params) if optimizer is not None
                    else None)


def grad_dtype_for(cfg: ModelConfig) -> torch.dtype:
    """bf16 accumulators for the 1T MoE (f32 would not fit), as in the JAX
    package; f32 for every other config."""
    return torch.bfloat16 if cfg.name == "kimi-k2-1t-a32b" else torch.float32


# ---------------------------------------------------------------------------
# Logical axes of the training tree (the axes half of the JAX init_*)
# ---------------------------------------------------------------------------

def param_axes(cfg: ModelConfig) -> PyTree:
    """The logical axes of every leaf of :func:`init_train_state`'s tree,
    stacks with a leading "layers", as the JAX ``init_model`` returns
    them."""
    norm = {"scale": ("embed",)}

    def attention():
        a = {"wq": ("embed", "q_proj"), "wk": ("embed", "kv_proj"),
             "wv": ("embed", "kv_proj"), "wo": ("q_proj", "embed")}
        if cfg.qkv_bias:
            a["bq"], a["bk"], a["bv"] = ("q_proj",), ("kv_proj",), (
                "kv_proj",)
        return a

    def layer(cross: bool):
        a: Dict[str, Any] = {}
        if has_attn(cfg):
            a["ln1"], a["attn"] = norm, attention()
        if has_ssm(cfg):
            a["lns"] = norm
            a["ssm"] = {"wx": ("embed", "ssm_inner"),
                        "wb": ("embed", "ssm_bc"), "wc": ("embed", "ssm_bc"),
                        "wa": ("embed", "ssm_heads"),
                        "wo": ("ssm_inner", "embed"),
                        "a_bias": ("ssm_heads",)}
        if cross:
            a["lnx"], a["xattn"] = norm, attention()
        if has_mlp(cfg):
            a["ln2"] = norm
            a["mlp"] = {"wi": ("embed", "ff"), "wg": ("embed", "ff"),
                        "wo": ("ff", "embed")}
        if cfg.block == "attn_moe":
            a["ln2"] = norm
            a["moe"] = {"router": ("embed", None),
                        "wi": ("expert", "embed", "ff"),
                        "wg": ("expert", "embed", "ff"),
                        "wo": ("expert", "ff", "embed")}
        return a

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return ("layers",) + tuple(tree)

    axes = {"embed": {"tok": ("vocab", "embed"), "out": ("embed", "vocab")},
            "layers": stacked(layer(cfg.encoder is not None)),
            "ln_f": norm}
    if cfg.encoder is not None:
        axes["enc_layers"] = stacked(layer(False))
        axes["enc_ln_f"] = norm
    return axes


def cache_spec_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Logical axes of each cache leaf (``init_cache``'s), as the JAX
    ``cache_spec_axes``: ``kv_cache_hd`` puts "kv_hd" on head_dim."""
    hd_ax = "kv_hd" if "kv_cache_hd" in cfg.perf_flags else None
    out: Dict[str, Tuple] = {}
    if has_attn(cfg):
        out["k"] = ("layers", "batch", None, "kv_heads", hd_ax)
        out["v"] = ("layers", "batch", None, "kv_heads", hd_ax)
    if has_ssm(cfg):
        out["ssm"] = ("layers", "batch", "ssm_heads", None, None)
    if cfg.encoder is not None:
        out["ck"] = ("layers", "batch", None, "kv_heads", hd_ax)
        out["cv"] = ("layers", "batch", None, "kv_heads", hd_ax)
    return out


# ---------------------------------------------------------------------------
# Spec trees (the JAX module's sharding half)
# ---------------------------------------------------------------------------

def state_shardings(cfg: ModelConfig, mesh, params: PyTree, axes: PyTree,
                    opt_state: Optional[PyTree] = None
                    ) -> Tuple[PyTree, Optional[PyTree], Dict]:
    """(parameter specs, optimizer-state specs or None, rules): each
    optimizer-state leaf inherits its parameter's spec, then gets the
    ZeRO-1 extension over the batch axes."""
    rules = dist.rules_for(cfg, mesh)
    with dist.use_mesh_rules(mesh, rules):
        p_sh = dist.shardings_for(axes, params, mesh, rules)
    opt_sh = None
    if opt_state is not None:
        opt_sh = dist.tree_rebuild(opt_state, lambda path, leaf: _zero1_one(
            _opt_spec(p_sh, path, leaf), tuple(leaf.shape), mesh))
    return p_sh, opt_sh, rules


_STATE_KEYS = ("m", "v", "f", "vr", "vc")


def _opt_spec(param_specs: PyTree, path: Tuple, leaf):
    """An optimizer-state leaf's parameter's spec (the parameter found by
    dropping the state keys m, v, f, vr, vc from the path): kept where it
    fits the leaf's rank (a factored vector keeps a prefix), else
    replicated."""
    node = param_specs
    for k in path:
        if k in _STATE_KEYS:
            continue
        if not isinstance(node, dict) or k not in node:
            raise KeyError(f"no param sharding for opt leaf {path}")
        node = node[k]
    if len(node) <= leaf.ndim:
        return tuple(node)[:leaf.ndim]
    return ()


def _zero1_one(spec, shape: Tuple[int, ...], mesh):
    """ZeRO-1: extend one state leaf's spec over the batch axes."""
    batch = dist.batch_axes(mesh)
    if not batch:
        return spec
    denom = int(np.prod([mesh.shape[a] for a in batch]))
    full = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in full:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            used.add(a)
    if any(a in used for a in batch):
        return spec
    best, best_size = None, 0
    for i, (e, size) in enumerate(zip(full, shape)):
        if e is None and size % denom == 0 and size > best_size:
            best, best_size = i, size
    if best is not None:
        full[best] = batch if len(batch) > 1 else batch[0]
    return tuple(full)


# ---------------------------------------------------------------------------
# Input specs per shape kind
# ---------------------------------------------------------------------------

def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def batch_entry(mesh, global_batch: int):
    """Mesh axes for the batch dim, or None when not divisible (the
    largest divisible suffix of the batch axes where there is one)."""
    axes = dist.batch_axes(mesh)
    if not axes:
        return None
    prod = int(np.prod([mesh.shape[a] for a in axes]))
    if global_batch % prod != 0:
        for k in range(len(axes) - 1, 0, -1):
            sub = axes[-k:]
            if global_batch % int(np.prod([mesh.shape[a] for a in sub])) == 0:
                return sub if len(sub) > 1 else sub[0]
        return None
    return axes if len(axes) > 1 else axes[0]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def row_spec(mesh) -> Tuple:
    """The spec of a batch's rows: over the batch axes, the rest whole."""
    batch = dist.batch_axes(mesh)
    return (batch if len(batch) > 1 else batch[0] if batch else None,)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
    """(the batch's leaves on ``meta``, their specs): rows over the batch
    axes."""
    GB, S = shape.global_batch, shape.seq_len
    row = row_spec(mesh)[0]
    sds = {"tokens": _meta((GB, S), torch.int32),
           "labels": _meta((GB, S), torch.int32)}
    sh = {"tokens": (row, None), "labels": (row, None)}
    if cfg.encoder is not None:
        sds["enc_embeds"] = _meta((GB, cfg.encoder.seq_len, cfg.d_model),
                                  _dtype(cfg))
        sh["enc_embeds"] = (row, None, None)
    elif cfg.frontend == "stub":
        sds["patch_embeds"] = _meta((GB, PATCH_TOKENS, cfg.d_model),
                                    _dtype(cfg))
        sh["patch_embeds"] = (row, None, None)
    return sds, sh


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple]]:
    """(the non-paged cache on ``meta``, its specs)."""
    sds = init_cache(cfg, batch, max_len, device="meta")
    rules = dist.rules_for(cfg, mesh)
    axes = cache_spec_axes(cfg)
    with dist.use_mesh_rules(mesh, rules):
        sh = {k: dist.spec_for(axes[k], rules, tuple(sds[k].shape))
              for k in sds}
    return sds, sh


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh
                         ) -> int:
    """Keep ~one 4k-token row per device per microbatch."""
    batch = dist.batch_axes(mesh)
    shards = int(np.prod([mesh.shape[a] for a in batch])) if batch else 1
    rows_per_dev = max(1, shape.global_batch // shards)
    rows_per_mb = max(1, 4096 // shape.seq_len)
    return max(1, rows_per_dev // rows_per_mb)


# ---------------------------------------------------------------------------
# The layout this slice realises
# ---------------------------------------------------------------------------

def expert_spec(mesh) -> Tuple:
    """A stacked expert leaf's spec (layers, experts, ...): the experts
    over the all-to-all's axes, as the schedule's ``shard_map`` takes
    them."""
    axes = a2a_axes(mesh)
    return (None, axes if len(axes) > 1 else axes[0])


def _is_expert(path: Tuple) -> bool:
    return ("moe" in path and path.index("moe") + 1 < len(path)
            and path[path.index("moe") + 1] in ("wi", "wg", "wo"))


def _spec_items(tree: PyTree, path: Tuple = ()):
    """(path, spec) pairs of a spec tree (dicts whose leaves are specs)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_items(tree[k], path + (k,))
    else:
        yield path, tree


def update_spec(cfg: ModelConfig, mesh, path: Tuple, spec, shape
                ) -> Tuple:
    """The spec of the slice of a parameter (at ``path``, held by
    ``spec``) a rank updates under ZeRO-1: ``spec`` extended over the batch
    axes, as its AdamW moments are; an expert stack of a ``moe_a2a``
    config as it is held."""
    if a2a_active(cfg, mesh) and _is_expert(path):
        return tuple(spec)
    return _zero1_one(tuple(spec), tuple(shape), mesh)


def state_layout(cfg: ModelConfig, mesh, params: PyTree,
                 opt_state: Optional[PyTree] = None) -> dist.Layout:
    """The layout of a whole state (on ``meta`` or not): of ``params``
    alone, or of the tuple ``(params, opt_state)``.  Parameters take
    :func:`state_shardings`' specs and optimizer-state leaves its ZeRO-1
    specs, but for a ``moe_a2a`` config's expert stacks and their state,
    held by :func:`expert_spec` (padded to a multiple of the group where E
    does not divide).  ``gathered`` lists the FSDP entries (over the batch
    axes, of more than one rank) of each parameter but those experts; a
    dense expert stack's expert dim is never among them (the layer runs
    the rank's experts, :mod:`~repro_torch.models.moe`)."""
    a2a = a2a_active(cfg, mesh)
    p_sh, o_sh, _ = state_shardings(cfg, mesh, params, param_axes(cfg),
                                    opt_state)
    if opt_state is None:
        tree, trees = params, {(): p_sh}
    else:
        tree, trees = (params, opt_state), {(0,): p_sh, (1,): o_sh}
    specs, gathered = {}, {}
    batch = set(dist.batch_axes(mesh))
    for prefix, sh in trees.items():
        for path, spec in _spec_items(sh):
            expert = a2a and _is_expert(path)
            specs[prefix + path] = expert_spec(mesh) if expert else spec
            entries = tuple((dim, dist.entry_axes(e)) for dim, e in
                            enumerate(spec) if dist.entry_axes(e)
                            and set(dist.entry_axes(e)) <= batch
                            and mesh.axis_size(dist.entry_axes(e)) > 1
                            and not (dim == 1 and _is_expert(path)))
            if prefix in ((), (0,)) and entries and not expert:
                gathered[prefix + path] = entries
    items = list(dist.tree_items(tree))
    return dist.Layout(mesh, specs,
                       {path: tuple(leaf.shape) for path, leaf in items},
                       {path: leaf.element_size() for path, leaf in items},
                       gathered)


def rank_state(cfg: ModelConfig, mesh, optimizer: Optimizer, *,
               seed: int = 0, device=None
               ) -> Tuple[PyTree, PyTree, dist.Layout]:
    """(this rank's parameters, its optimizer state, the layout of both):
    each parameter leaf built whole from the seed (the generator's draws
    of :func:`~repro_torch.models.init_train_state`, in its order), the
    rank's part kept and the whole freed before the next leaf, so the
    peak is the rank's state and one whole leaf a layer; the parameters
    equal ``layout.shard(init_train_state(cfg, seed=seed))`` bit for bit.
    The optimizer state is zeros (every optimizer's initial state) of the
    rank's part of each leaf."""
    p_meta, o_meta = abstract_state(cfg, optimizer)
    layout = state_layout(cfg, mesh, p_meta, o_meta)
    params_lay = layout.part(0)

    def keep(path, x, lead):
        spec = params_lay.spec(path)[lead:]
        return dist.local_shard(x, spec, mesh)

    dev = resolve_device(device)
    params = init_train_state(cfg, seed=seed, device=dev, keep=keep)
    return params, layout.part(1).zeros(o_meta, dev), layout
