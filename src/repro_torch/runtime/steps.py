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

import torch
import torch.distributed as tdist

from ..artifacts.dispatch import get_default_cache
from ..core.params import H100_SXM, MachineDescription
from ..kernels.ops import FAMILIES
from ..models.config import ModelConfig
from ..models.transformer import check_train, decode_step, forward, prefill
from ..optim import Optimizer, clip_by_global_norm, tree_leaves, tree_map
from ..plans.trace import (TracedOp, trace_steps_warm_set,
                           trace_train_warm_set)

MOE_AUX_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token NLL and z-loss (log^2 Z), both in f32: (nll, z)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
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
    nll, z = cross_entropy(logits, labels)
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
    step over that mesh, data parallel: every rank gets the whole batch
    and takes its rows of each microbatch by the batch spec
    (``launch.specs.train_batch_specs``), so a microbatch holds the rows
    the JAX step's does; ``params`` and ``opt_state`` are the rank's parts
    of the state (``launch.specs.state_layout``: the experts of a
    ``moe_a2a`` config sharded over the all-to-all's group, every other
    leaf whole), and the model runs under ``use_mesh_rules(mesh)``.  Each
    rank's loss is its rows' mean, so the gradient of the whole batch's
    loss is the sum of every rank's over the number of ranks: a
    replicated leaf's gradient is all-reduced (GSPMD's psum), an expert
    shard's already holds every rank's tokens (the all-to-all's adjoint)
    and is only scaled.  The clipping norm sums the shards' squares over
    their group, Adafactor's RMS too.  An ``attn_moe`` config trains on
    more than one rank through ``moe_a2a`` only: without it the JAX layer
    routes the whole batch's groups, each rank here would route its own.
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


def _mesh_train_step(cfg: ModelConfig, optimizer: Optimizer,
                     microbatches: int, clip_norm: float,
                     grad_dtype: torch.dtype, mesh) -> Callable:
    """:func:`build_train_step`'s step over ``mesh``."""
    from ..distributed import sharding as dist
    from ..launch.specs import row_spec, state_layout
    from ..models.moe import a2a_padded_experts
    from ..models.moe_a2a import a2a_active

    n = mesh.size
    if cfg.block == "attn_moe" and not a2a_active(cfg, mesh) and n > 1:
        raise NotImplementedError(
            f"config {cfg.name} on {n} ranks needs perf flag 'moe_a2a': "
            "the dense MoE layer routes each rank's rows, the JAX layer "
            "the whole batch's")
    rules = dist.rules_for(cfg, mesh)
    row = row_spec(mesh)
    shards_of_rows = mesh.axis_size(dist.batch_axes(mesh))

    def reduce_over(group):
        def reduce(t):
            t = t.clone()
            tdist.all_reduce(t, group=group)
            return t
        return reduce

    def train_step(params, opt_state, batch, step):
        B = batch["tokens"].shape[0]
        if B % (microbatches * shards_of_rows):
            raise ValueError(f"batch {B} not a multiple of {microbatches} "
                             "microbatches of the mesh's batch shards")
        mb = B // microbatches
        layout = state_layout(cfg, mesh, params)
        # the sharded leaves (experts): id -> (group, whole leaf's count)
        shards = {}
        for path, p in dist.tree_items(params):
            if layout.sharded(path):
                group = mesh.group(dist.entry_axes(layout.spec(path)[1]))
                whole = p.numel() // p.shape[1] * a2a_padded_experts(cfg)
                shards[id(p)] = (group, whole)
        leaves = tree_leaves(params)
        with dist.use_mesh_rules(mesh, rules):
            sums, acc = _accumulate(params, cfg, grad_dtype, (
                {k: dist.local_shard(
                    torch.as_tensor(v)[i * mb:(i + 1) * mb], row, mesh)
                 for k, v in batch.items()}
                for i in range(microbatches)))
        with torch.no_grad():
            sq = []
            for p in leaves:
                g = acc[id(p)]
                if id(p) not in shards:
                    tdist.all_reduce(g, group=mesh.world)
                g.div_(microbatches * n)
                part = torch.sum(torch.square(g.float()))
                if id(p) in shards:
                    tdist.all_reduce(part, group=shards[id(p)][0])
                sq.append(part)
            grads, gnorm = clip_by_global_norm(
                tree_map(lambda p: acc[id(p)], params), clip_norm,
                torch.sqrt(torch.sum(torch.stack(sq))))
            optimizer.update(grads, opt_state, params, step, shards={
                k: (reduce_over(g), whole)
                for k, (g, whole) in shards.items()})
            tdist.all_reduce(sums, group=mesh.world)
            sums /= microbatches * n
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


def build_serve_steps(cfg: ModelConfig) -> Tuple[Callable, Callable]:
    """(prefill_step, decode_one) of the non-paged serve path.

    prefill_step(params, tokens, cache[, enc_embeds/patch_embeds])
        -> (last_logits, cache)
    decode_one(params, tokens (B, 1), cache, index) -> (logits, cache)
    """

    def prefill_step(params, tokens, cache, **kw):
        return prefill(params, cfg, tokens, cache, **kw)

    def decode_one(params, tokens, cache, index):
        return decode_step(params, cfg, tokens, cache, index)

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
