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

``update`` also takes ``shards``, for a leaf of which a rank updates a
slice (its part of a sharded leaf, ZeRO-1's slice of that part, the
experts of the ``moe_a2a`` schedule): ``{id(param): Part}``, the param
and its gradient being the slice.  Adafactor takes its factored moments
and its update's RMS over the whole leaf through it (:class:`Part`);
AdamW is elementwise and needs none.

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

def _narrow(t: torch.Tensor, start, size) -> torch.Tensor:
    for dim, (a, n) in enumerate(zip(start, size)):
        t = t.narrow(dim, a, n)
    return t


def _drop(seq, dims) -> list:
    keep = set(range(len(seq))) - {d % len(seq) for d in dims}
    return [v for i, v in enumerate(seq) if i in keep]


@dataclasses.dataclass(frozen=True)
class Part:
    """The slice of a leaf a rank updates, within the whole leaf (an entry
    of ``update``'s ``shards``).  ``shape`` is the whole leaf's (padded
    where its parts are padded), ``start`` the slice's first index along
    each dim, ``count`` the whole leaf's elements.  ``total(t)`` sums a
    statistic of the slice over every rank, each slice of the leaf once
    (its replicas add nothing); ``whole(key, s)`` is the leaf's state
    leaf ``s`` (``"vr"``, ``"vc"``) whole, from every rank's part, and
    ``keep(key, s, w)`` stores the rank's part of the whole ``w`` in
    ``s``."""
    shape: Tuple[int, ...]
    start: Tuple[int, ...]
    count: int
    total: Callable[[torch.Tensor], torch.Tensor]
    whole: Callable[[str, torch.Tensor], torch.Tensor]
    keep: Callable[[str, torch.Tensor, torch.Tensor], None]

    def place(self, t: torch.Tensor, drop: int) -> torch.Tensor:
        """``t``, a statistic of the slice reduced over dim ``drop``, in
        zeros of the whole leaf's shape without that dim."""
        out = t.new_zeros(_drop(self.shape, [drop]))
        _narrow(out, _drop(self.start, [drop]), t.shape).copy_(t)
        return out

    def cut(self, w: torch.Tensor, drop, size) -> torch.Tensor:
        """The slice's part of ``w``, a statistic of the whole leaf
        reduced over the dims ``drop``; ``size``: the slice's shape."""
        return _narrow(w, _drop(self.start, drop), _drop(size, drop))


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
            part = (shards or {}).get(id(p))
            g = g.float()
            g2 = g * g + eps
            if _factored(p) and part is not None:
                # the whole leaf's moments: each mean sums the slices' sums
                # across the ranks that split the dim it reduces
                rows = part.total(part.place(g2.sum(-1), -1))
                cols = part.total(part.place(g2.sum(-2), -2))
                vr = beta * part.whole("vr", s["vr"]) + (1 - beta) * (
                    rows / part.shape[-1])
                vc = beta * part.whole("vc", s["vc"]) + (1 - beta) * (
                    cols / part.shape[-2])
                part.keep("vr", s["vr"], vr)
                part.keep("vc", s["vc"], vc)
                denom = torch.clamp(vr.mean(-1), min=eps)
                size = g.shape
                vr, vc = part.cut(vr, [-1], size), part.cut(vc, [-2], size)
                denom = part.cut(denom, [-2, -1], size)
                vhat = (vr[..., :, None] * vc[..., None, :]) / \
                    denom[..., None, None]
                u = g / torch.sqrt(vhat + eps)
            elif _factored(p):
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
            if part is None:
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            else:
                rms = torch.sqrt(part.total(torch.sum(torch.square(u)))
                                 / part.count + 1e-12)
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
