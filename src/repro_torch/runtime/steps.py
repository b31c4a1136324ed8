"""Step builders of the port (``runtime/steps.py``): the train and eval
steps, the non-paged serve steps, their kernel warm-up, and greedy
sampling.

``build_train_step`` is the JAX package's: microbatched gradient
accumulation in ``grad_dtype``, the mean over the microbatches, global-norm
clipping, the MoE auxiliary loss and the z-loss in the loss, and the
optimizer's update.  The port runs the microbatches in a Python loop
(autograd over K1, K2, K3, K4, their batched entries, K2b and K3b:
:mod:`repro_torch.kernels.autograd`)
and updates the parameters and the optimizer state **in place**: a
functional update would hold two or three copies of the training state.

``build_serve_steps(cfg)`` is how whisper-large-v3 is served, as in the JAX
package (whose engine and launcher refuse encoder-decoder configs):
``prefill_step(params, tokens, cache, enc_embeds=...)`` then
``decode_one(params, tokens, cache, index)`` on a cache from
``models.init_cache``.  The decode step reads its index on the device and
does no host work, so a CUDA graph (``runtime.graph``) can capture it once
and replay it a token.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..artifacts.dispatch import get_default_cache
from ..core.params import H100_SXM, MachineDescription
from ..device import resolve_device
from ..kernels.ops import FAMILIES
from ..models.config import ModelConfig
from ..models.transformer import (check_block, check_mesh, check_train,
                                  decode_step, forward, prefill)
from ..optim import (Optimizer, Part, clip_by_global_norm, tree_leaves,
                     tree_map)
from ..plans.trace import (TracedOp, trace_steps_warm_set,
                           trace_train_warm_set)

MOE_AUX_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token NLL and z-loss (log^2 Z), both in f32: (nll, z).  Where
    ``logits`` are the rank's columns of ``vocab`` (the config's; a
    vocab-parallel ``unembed``), vocab-parallel over the current mesh's
    ``model`` axis: the max and the sum of exponentials all-reduced, the
    gold logit taken from the rank that holds it."""
    logits = logits.float()
    if logits.shape[-1] == vocab:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(logz - gold), torch.mean(torch.square(logz))
    from ..distributed import sharding as dist
    from ..distributed.comm import all_reduce_, reduce_from
    mesh = dist.current_mesh()
    group = mesh.group(("model",))
    n = logits.shape[-1]
    top = all_reduce_(logits.detach().amax(dim=-1), group, "max")
    sums = reduce_from(torch.exp(logits - top[..., None]).sum(-1), group)
    logz = top + torch.log(sums)
    local = labels.long() - mesh.coords()["model"] * n
    held = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(held, local, 0)[..., None])
    gold = reduce_from(gold[..., 0] * held, group)
    return torch.mean(logz - gold), torch.mean(torch.square(logz))


def _batch_extras(cfg: ModelConfig, batch: Dict[str, Any]) -> Dict:
    kw = {}
    if cfg.encoder is not None:
        kw["enc_embeds"] = batch["enc_embeds"]
    elif cfg.frontend == "stub" and "patch_embeds" in batch:
        kw["patch_embeds"] = batch["patch_embeds"]
    return kw


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"nll", "moe_aux", "z"}) of a batch {"tokens", "labels"[,
    "enc_embeds" | "patch_embeds"]} (tensors or numpy arrays): nll + 0.01 *
    aux + 1e-4 * z.  While autograd records, the config must be one the
    port trains (:func:`~repro_torch.models.transformer.check_train`)."""
    if torch.is_grad_enabled():
        check_train(cfg)
    logits, aux = forward(params, cfg, batch["tokens"],
                          **_batch_extras(cfg, batch))
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    nll, z = cross_entropy(logits, labels, cfg.vocab)
    loss = nll + MOE_AUX_WEIGHT * aux + Z_LOSS_WEIGHT * z
    return loss, {"nll": nll, "moe_aux": aux, "z": z}


def build_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                     microbatches: int = 1, clip_norm: float = 1.0,
                     grad_dtype: torch.dtype = torch.float32,
                     mesh=None) -> Callable:
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``: ``params`` and ``opt_state`` are updated in
    place and returned; ``metrics`` {"loss", "nll", "moe_aux",
    "grad_norm"} are 0-d f32 tensors on the device (no host read).  The
    batch's rows split into ``microbatches`` consecutive groups; each
    group's gradients (autograd's, accumulated in the parameters' ``.grad``,
    or in ``grad_dtype`` accumulators where that differs from a
    parameter's type) are summed, divided by ``microbatches``, clipped to
    ``clip_norm`` by their global norm, and handed to ``optimizer.update``.
    Raises at build time for a config the port does not train.

    With a ``mesh`` (:mod:`repro_torch.launch.mesh`) the step is the JAX
    step jitted with ``state_shardings``' shardings over that mesh: every
    rank gets the whole batch and takes its rows of each microbatch by the
    batch spec (``launch.specs.train_batch_specs``), so a microbatch holds
    the rows the JAX step's does; ``params`` and ``opt_state`` are the
    rank's parts of the state (``launch.specs.state_layout``,
    ``launch.specs.rank_state``), and the model runs under
    ``use_mesh_rules(mesh, rules, layout)``: tensor parallelism over
    ``model`` (``models.layers``), each layer's FSDP leaves gathered on
    entry (``models.transformer``), the ``moe_a2a`` schedule.  Each rank's
    loss is its rows' mean, the ranks along ``model`` computing one loss
    together, so a gradient is summed over the batch axes on which its
    leaf is replicated (not over those an FSDP gather's adjoint already
    summed) and divided by the number of row shards; the loss and the
    metrics count each row once.  ZeRO-1: a leaf whose update spec
    (``launch.specs.update_spec``) shards a dim over the batch axes gets
    its gradient reduce-scattered along it, the optimizer updates the
    rank's slice from the rank's state (``optim.Part`` carries the whole
    leaf's statistics), and the slices are all-gathered back into the
    parameter.  The clipping norm counts each element's square once.
    A mesh over axes other than ("pod", "data", "model") raises
    (:func:`~repro_torch.models.transformer.check_mesh`).
    Without a mesh nothing changes."""
    check_train(cfg)
    if mesh is not None:
        return _mesh_train_step(cfg, optimizer, microbatches, clip_norm,
                                grad_dtype, mesh)

    def train_step(params, opt_state, batch, step):
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} not a multiple of {microbatches} "
                             "microbatches")
        mb = B // microbatches
        leaves = tree_leaves(params)
        sums, acc = _accumulate(params, cfg, grad_dtype, (
            {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(microbatches)))
        with torch.no_grad():
            for g in acc.values():
                g.div_(microbatches)
            grads, gnorm = clip_by_global_norm(
                tree_map(lambda p: acc[id(p)], params), clip_norm)
            optimizer.update(grads, opt_state, params, step)
        for p in leaves:
            p.grad = None
        sums /= microbatches
        metrics = {"loss": sums[0], "nll": sums[1], "moe_aux": sums[2],
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


def _accumulate(params, cfg: ModelConfig, grad_dtype: torch.dtype,
                mbatches) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """Forward and backward of each microbatch of ``mbatches``: ((loss,
    nll, aux) summed, {id(param): its gradients summed})."""
    leaves = tree_leaves(params)
    native = all(p.dtype == grad_dtype for p in leaves)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    acc: Dict[int, torch.Tensor] = {}
    sums = torch.zeros(3, dtype=torch.float32, device=leaves[0].device)
    for mbatch in mbatches:
        loss, metr = loss_fn(params, cfg, mbatch)
        loss.backward()
        sums += torch.stack([loss, metr["nll"], metr["moe_aux"]]).detach()
        if not native:
            for p in leaves:
                g = (p.grad if p.grad is not None
                     else torch.zeros_like(p)).to(grad_dtype)
                acc[id(p)] = g if id(p) not in acc else acc[id(p)].add_(g)
                p.grad = None
    if native:
        acc = {id(p): p.grad if p.grad is not None
               else torch.zeros_like(p) for p in leaves}
    return sums, acc


class _LeafPlan:
    """How the mesh step reduces and updates one parameter leaf."""

    def __init__(self, cfg, mesh, path, layout, opt_layout):
        from ..distributed import sharding as dist
        from ..launch.specs import update_spec
        batch = dist.batch_axes(mesh)
        spec = layout.spec(path)
        held = {a for e in spec for a in dist.entry_axes(e)}
        upd = update_spec(cfg, mesh, path, spec, layout.shapes[path])
        used = {a for e in upd for a in dist.entry_axes(e)}
        before = tuple(spec) + (None,) * (len(upd) - len(spec))
        self.zdim = next((d for d, (e, f) in enumerate(zip(upd, before))
                          if dist.entry_axes(e) != dist.entry_axes(f)), None)
        if mesh.axis_size(batch) == 1:
            self.zdim = None
        self.batch_group = mesh.group(batch) if batch else None
        # summed over the batch axes the leaf is replicated on; an FSDP
        # leaf's gather and an expert shard's all-to-all summed the rest
        rest = tuple(a for a in batch if a not in held)
        self.sum_group = mesh.group(rest) if rest else None
        self.owner = all(c == 0 for a, c in mesh.coords().items()
                         if a not in used)
        self.shape = dist.shard_shape(layout.shapes[path], spec, mesh)
        self.part = None
        states = {k: opt_layout.spec(sp) for k in ("vr", "vc", "v")
                  for sp in [("f",) + path + (k,)] if sp in opt_layout.specs}
        split = [e for sp in [upd, *states.values()] for e in sp
                 if mesh.axis_size(dist.entry_axes(e)) > 1]
        if split:
            self.part = self._part(mesh, upd, states, layout.shapes[path],
                                   self.owner)

    @staticmethod
    def _part(mesh, upd, states, whole, owner) -> Part:
        """The optimizer's view of the slice ``upd`` gives the rank."""
        from ..distributed import sharding as dist
        shape = dist.shard_shape(whole, upd, mesh)
        start = [0] * len(whole)
        padded = list(shape)
        for d, e in enumerate(upd):
            axes = dist.entry_axes(e)
            start[d] = mesh.axis_index(axes) * shape[d]
            padded[d] = shape[d] * mesh.axis_size(axes)

        def total(t):
            from ..distributed.comm import all_reduce_
            t = t if owner else torch.zeros_like(t)
            return all_reduce_(t, mesh.world)

        def whole_of(key, s):
            return dist.gather_shard(s, states[key], mesh)

        def keep(key, s, w):
            s.copy_(dist.local_shard(w, states[key], mesh))

        return Part(tuple(padded), tuple(start),
                    int(np.prod(whole)), total, whole_of, keep)


def _mesh_train_step(cfg: ModelConfig, optimizer: Optimizer,
                     microbatches: int, clip_norm: float,
                     grad_dtype: torch.dtype, mesh) -> Callable:
    """:func:`build_train_step`'s step over ``mesh``."""
    from ..distributed import sharding as dist
    from ..distributed.comm import all_reduce_, gather_along, reduce_scatter
    from ..launch.specs import abstract_state, row_spec, state_layout

    check_mesh(cfg, mesh)
    rules = dist.rules_for(cfg, mesh)
    row = row_spec(mesh)
    shards_of_rows = mesh.axis_size(dist.batch_axes(mesh))
    p_meta, o_meta = abstract_state(cfg, optimizer)
    full = state_layout(cfg, mesh, p_meta, o_meta)
    layout, opt_layout = full.part(0), full.part(1)
    paths = [path for path, _ in dist.tree_items(p_meta)]
    plans = [_LeafPlan(cfg, mesh, path, layout, opt_layout)
             for path in paths]
    batch_group = mesh.group(dist.batch_axes(mesh)) \
        if dist.batch_axes(mesh) else mesh.world

    def train_step(params, opt_state, batch, step):
        B = batch["tokens"].shape[0]
        if B % (microbatches * shards_of_rows):
            raise ValueError(f"batch {B} not a multiple of {microbatches} "
                             "microbatches of the mesh's batch shards")
        mb = B // microbatches
        leaves = tree_leaves(params)
        for path, plan, p in zip(paths, plans, leaves):
            if tuple(p.shape) != plan.shape:
                raise ValueError(f"parameter {path} of shape "
                                 f"{tuple(p.shape)}: its part under the "
                                 f"mesh's layout is {plan.shape}")
        with dist.use_mesh_rules(mesh, rules, layout):
            sums, acc = _accumulate(params, cfg, grad_dtype, (
                {k: dist.local_shard(
                    torch.as_tensor(v)[i * mb:(i + 1) * mb], row, mesh)
                 for k, v in batch.items()}
                for i in range(microbatches)))
        with torch.no_grad():
            sq, views, grads, shards = [], {}, {}, {}
            for p, plan in zip(leaves, plans):
                g = acc[id(p)]
                if plan.zdim is not None:
                    g = reduce_scatter(g, plan.zdim, plan.batch_group)
                    n = g.shape[plan.zdim]
                    idx = mesh.axis_index(dist.batch_axes(mesh))
                    view = p.narrow(plan.zdim, idx * n, n)
                else:
                    if plan.sum_group is not None:
                        all_reduce_(g, plan.sum_group)
                    view = p
                g.div_(microbatches * shards_of_rows)
                views[id(p)], grads[id(p)] = view, g
                if plan.part is not None:
                    shards[id(view)] = plan.part
                sq.append(torch.sum(torch.square(g.float())) if plan.owner
                          else torch.zeros((), dtype=torch.float32,
                                           device=g.device))
            total = torch.sum(torch.stack(sq))
            all_reduce_(total, mesh.world)
            grads, gnorm = clip_by_global_norm(
                tree_map(lambda p: grads[id(p)], params), clip_norm,
                torch.sqrt(total))
            optimizer.update(grads, opt_state,
                             tree_map(lambda p: views[id(p)], params), step,
                             shards=shards)
            for p, plan in zip(leaves, plans):
                if plan.zdim is not None:
                    p.copy_(gather_along(views[id(p)], plan.zdim,
                                         plan.batch_group))
            all_reduce_(sums, batch_group)
            sums /= microbatches * shards_of_rows
        for p in leaves:
            p.grad = None
        metrics = {"loss": sums[0], "nll": sums[1], "moe_aux": sums[2],
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


def build_eval_step(cfg: ModelConfig) -> Callable:
    """``eval_step(params, batch) -> {"loss", "nll", "moe_aux", "z"}``,
    with autograd off."""
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metr = loss_fn(params, cfg, batch)
        return {"loss": loss, **metr}
    return eval_step


def warm_train_dispatch(cfg: ModelConfig, *, global_batch: int, seq: int,
                        microbatches: int = 1,
                        machine: MachineDescription = H100_SXM,
                        mesh=None) -> Dict[str, Any]:
    """Freeze every kernel pick a train step over ``global_batch`` rows of
    ``seq`` tokens in ``microbatches`` asks for
    (:func:`~repro_torch.plans.trace.trace_train_warm_set`): K1's forward
    and backward products, K4's transposes, K2 and K2b, K3 and K3b; after
    it a step resolves nothing cold.  ``mesh``: the step's (a rank's
    keys)."""
    return freeze_traced(trace_train_warm_set(
        cfg, global_batch=global_batch, seq=seq,
        microbatches=microbatches, mesh=mesh), machine)


def build_serve_steps(cfg: ModelConfig, mesh=None
                      ) -> Tuple[Callable, Callable]:
    """(prefill_step, decode_one) of the non-paged serve path.

    prefill_step(params, tokens, cache[, enc_embeds/patch_embeds])
        -> (last_logits, cache)
    decode_one(params, tokens (B, 1), cache, index) -> (logits, cache)

    With a ``mesh`` the steps are JAX's dry run's, sharded over it:
    ``params`` are the rank's parts of the training tree by
    ``launch.specs.state_layout`` (the layers stacked), ``cache`` the
    rank's part of ``init_cache``'s by ``launch.specs.cache_specs``
    (:func:`rank_cache`), and every rank gets the whole batch (tokens and
    ``enc_embeds`` / ``patch_embeds``) and takes its rows by
    ``launch.specs.batch_entry``.  The layers run as the mesh train step
    runs them (FSDP leaves gathered on use, tensor parallelism over
    ``model``: attention, the SSD block, the MLP, whisper's encoder and
    cross-attention, the dense MoE layer's experts over ``data``), each
    reading and writing its rank's KV and SSD heads of the cache; the
    vocab-parallel lm_head's columns are gathered over ``model`` and the
    rows over the batch axes, so every rank returns the whole batch's
    logits (JAX's replicated ``out_shardings``).  Without a mesh nothing
    changes; the paged engine runs on one card, as in JAX."""
    if mesh is not None:
        return _mesh_serve_steps(cfg, mesh)

    def prefill_step(params, tokens, cache, **kw):
        return prefill(params, cfg, tokens, cache, **kw)

    def decode_one(params, tokens, cache, index):
        return decode_step(params, cfg, tokens, cache, index)

    return prefill_step, decode_one


def rank_cache(cfg: ModelConfig, mesh, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, device=None
               ) -> Dict[str, torch.Tensor]:
    """The rank's part of ``init_cache(cfg, batch, max_len)`` on ``mesh``
    by ``launch.specs.cache_specs`` (zeros, as the whole is)."""
    from ..distributed import sharding as dist
    from ..launch.specs import cache_specs
    from ..models.transformer import init_cache
    meta, specs = cache_specs(cfg, batch, max_len, mesh)
    whole = init_cache(cfg, batch, max_len, dtype, device="meta")
    return {k: torch.zeros(dist.shard_shape(meta[k].shape, specs[k], mesh),
                           dtype=whole[k].dtype,
                           device=resolve_device(device))
            for k in meta}


def _mesh_serve_steps(cfg: ModelConfig, mesh) -> Tuple[Callable, Callable]:
    """:func:`build_serve_steps`' steps over ``mesh``."""
    from ..distributed import sharding as dist
    from ..distributed.comm import gather_along
    from ..launch.specs import abstract_state, batch_entry, state_layout

    check_block(cfg)
    check_mesh(cfg, mesh)
    rules = dist.rules_for(cfg, mesh)
    p_meta, _ = abstract_state(cfg)
    layout = state_layout(cfg, mesh, p_meta)

    def rows(batch: int):
        """(the rows' spec entry, its axes' group or None)."""
        entry = batch_entry(mesh, batch)
        axes = dist.entry_axes(entry)
        n = mesh.axis_size(axes)
        return entry, (mesh.group(axes) if n > 1 else None)

    def mine(x, entry):
        return dist.local_shard(torch.as_tensor(x), (entry,), mesh) \
            if x is not None else None

    def whole(logits, group):
        return gather_along(logits, 0, group) if group is not None \
            else logits

    def prefill_step(params, tokens, cache, **kw):
        entry, group = rows(tokens.shape[0])
        kw = {k: mine(v, entry) for k, v in kw.items()}
        with torch.no_grad(), dist.use_mesh_rules(mesh, rules, layout):
            logits, cache = prefill(params, cfg, mine(tokens, entry), cache,
                                    **kw)
            return whole(logits, group), cache

    def decode_one(params, tokens, cache, index):
        entry, group = rows(tokens.shape[0])
        if isinstance(index, torch.Tensor) and index.dim() == 1:
            index = mine(index, entry)
        with torch.no_grad(), dist.use_mesh_rules(mesh, rules, layout):
            logits, cache = decode_step(params, cfg, mine(tokens, entry),
                                        cache, index)
            return whole(logits, group), cache

    return prefill_step, decode_one


def freeze_traced(ops: Sequence[TracedOp],
                  machine: MachineDescription) -> Dict[str, Any]:
    """Resolve every traced op through the process cache's tiers and pin
    them into its frozen lane; returns ``{label: {"candidate": Candidate,
    "rank_source": str}}``."""
    plan = get_default_cache().freeze(
        [(FAMILIES[op.family], machine, op.data_dict()) for op in ops])
    picks: Dict[str, Any] = {}
    for op in ops:
        ent = plan.get(op.family, machine.name, op.data_dict())
        picks[op.label] = {"candidate": ent.candidate,
                           "rank_source": ent.source}
    return picks


def warm_steps_dispatch(cfg: ModelConfig, *, batch: int, prompt_len: int,
                        max_len: int,
                        machine: MachineDescription = H100_SXM
                        ) -> Dict[str, Any]:
    """Freeze every kernel pick the non-paged steps ask for at (``batch``,
    ``prompt_len``, ``max_len``)
    (:func:`~repro_torch.plans.trace.trace_steps_warm_set`), as
    ``serving.warm_kernel_dispatch`` does for the engine; after it a
    prefill and the decode steps that follow resolve nothing cold."""
    return freeze_traced(trace_steps_warm_set(
        cfg, batch=batch, prompt_len=prompt_len, max_len=max_len), machine)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 argmax tokens (first maximum on ties,
    as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
