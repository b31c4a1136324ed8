"""AdamW and Adafactor over trees of tensors, plus clipping and schedules
(the port of ``repro.optim.optimizers``).

A tree is nested dicts (or lists and tuples) of tensors, as the training
state of :func:`repro_torch.models.init_train_state` is: the JAX package's
layout, stacked layers included.  That matters for Adafactor, which factors
every leaf of two or more dims and takes its update's RMS over the whole
leaf: a stacked norm scale [L, d] is factored, and its RMS spans all L
layers, exactly as in the JAX package.

Interface, as in the JAX package::

    opt = adamw(lr_schedule, weight_decay=0.1)
    state = opt.init(params)
    params, state = opt.update(grads, state, params, step)

``update`` also takes ``shards``, for a leaf that is one rank's part of a
whole (the experts of the ``moe_a2a`` schedule): ``{id(param): (reduce,
count)}``, ``reduce`` summing a 0-d tensor over the ranks that share the
leaf and ``count`` the whole leaf's elements.  Adafactor takes its update's
RMS over the whole leaf through it; AdamW is elementwise and needs none.

``update`` runs under ``torch.no_grad()`` and updates ``params`` and
``state`` **in place** (the JAX one returns new trees): a functional update
would hold two or three copies of the training state.  It returns the same
objects.  The scalars of a step (the learning rate, the bias corrections,
Adafactor's decay) are f32, as the JAX ones are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

PyTree = Any
Schedule = Callable[[int], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    """The tensors of a tree in ``jax.tree_util``'s order: dict keys
    sorted, sequences in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, params: PyTree, *rest: PyTree) -> PyTree:
    """``fn(p, *r)`` at every leaf p of ``params``, with the subtrees of
    ``rest`` at the same path passed whole (Adafactor's per-leaf state
    dicts hang below a parameter's path)."""
    if isinstance(params, dict):
        return {k: tree_map(fn, params[k], *(r[k] for r in rest))
                for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(tree_map(fn, p, *(r[i] for r in rest))
                            for i, p in enumerate(params))
    return fn(params, *rest)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def constant(lr: float) -> Schedule:
    return lambda step: _f32(lr)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Schedule:
    def sched(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / max(1, warmup_steps), max=1.0)
        frac = torch.clamp((step - warmup_steps) /
                           max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


# ---------------------------------------------------------------------------
# Gradient clipping
# ---------------------------------------------------------------------------

@torch.no_grad()
def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def clip_by_global_norm(grads: PyTree, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[PyTree, torch.Tensor]:
    """Scales ``grads`` in place by min(1, max_norm / norm); returns
    (grads, norm).  ``norm`` is :func:`global_norm` unless given (a
    sharded tree's, summed over its ranks)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm


# ---------------------------------------------------------------------------
# Optimizer container
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, int], Tuple[PyTree, PyTree]]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: Schedule, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        stepf = _f32(step) + 1.0
        lr_t = lr(step)
        c1 = 1.0 - _f32(b1) ** stepf
        c2 = 1.0 - _f32(b2) ** stepf

        def upd(p, g, m, v):
            # the JAX formulas, updated in place: two temporaries the size
            # of the leaf at most (a 4 GB embedding adds 8 GB, not 16)
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = torch.sqrt(v / c2).add_(eps)
            delta = torch.div(m, c1).div_(denom)
            del denom
            delta.add_(p.float(), alpha=weight_decay).mul_(lr_t)
            p.sub_(delta)

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer("adamw", init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments — the 1T-param MoE choice)
# ---------------------------------------------------------------------------

def adafactor(lr: Schedule, *, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Shazeer & Stern 2018, factored for params with ndim >= 2: row/col
    second-moment vectors over the two trailing dims."""
    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def per_leaf(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"f": tree_map(per_leaf, params)}

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        stepf = _f32(step) + 1.0
        lr_t = lr(step)
        beta = 1.0 - stepf ** (-decay)

        def upd(p, g, s):
            g = g.float()
            g2 = g * g + eps
            if _factored(p):
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(-2))
                vr, vc = s["vr"], s["vc"]
                # rank-1 reconstruction of the second moment
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                vhat = (vr[..., :, None] * vc[..., None, :]) / denom[..., None]
                u = g / torch.sqrt(vhat + eps)
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g / torch.sqrt(s["v"] + eps)
            # update clipping (RMS over the whole leaf)
            part = (shards or {}).get(id(p))
            if part is None:
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            else:
                reduce, count = part
                rms = torch.sqrt(reduce(torch.sum(torch.square(u))) / count
                                 + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_((p - lr_t * u).to(p.dtype))

        tree_map(upd, params, grads, state["f"])
        return params, state

    return Optimizer("adafactor", init, update)


def make_optimizer(name: str, lr: Schedule, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
