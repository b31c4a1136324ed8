"""Gradient compression: int8 ring all-reduce over the pod axis (the port
of ``repro.distributed.compression``).

Each block is quantised to int8 with a per-tensor f32 scale (stochastic
rounding keeps the estimator unbiased), passed around a ring over the
mesh's ``pod`` group with ``batch_isend_irecv`` (int8 and its scale on the
wire, 4x fewer bytes than f32), and dequantised into the sum.

The rounding noise comes from an explicit ``torch.Generator``: leaf i of
:func:`compressed_psum_pod` draws from ``seed`` folded by i, and the ring's
rank r from that folded by r, as the JAX module folds its key.  The numbers
are torch's, not ``jax.random``'s; :func:`_quantize` takes its noise as an
argument, so the same noise gives the JAX function's int8 values and scale
bit for bit.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..optim import tree_leaves, tree_map

PyTree = Any

_FOLD = 0x9E3779B97F4A7C15          # odd 64-bit constant (golden ratio)


def fold_in(seed: int, data: int) -> int:
    """A seed derived from (``seed``, ``data``), as ``jax.random.fold_in``
    derives a key: distinct data give unrelated streams."""
    return (seed * _FOLD + data + 1) % (1 << 63)


def _noise(shape, seed: int, device) -> torch.Tensor:
    """Uniform noise in [-0.5, 0.5), f32, from a generator seeded ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.rand(shape, generator=g, device=device,
                      dtype=torch.float32) - 0.5


def _quantize(x: torch.Tensor, noise: torch.Tensor):
    """(int8 q, f32 scale) of f32 ``x``: scale = max|x| / 127, q the
    stochastic rounding of x / scale under ``noise``, clipped to ±127."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    y = x / scale
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _ring_allreduce_int8(x: torch.Tensor, seed: int, group) -> torch.Tensor:
    """All-reduce of f32 ``x`` over ``group`` moving int8 on the wire: each
    rank's quantised block travels the ring n - 1 hops, every rank adding
    each one as it passes."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    q, scale = _quantize(x, _noise(x.shape, fold_in(seed, idx), x.device))
    acc = _dequantize(q, scale)           # own (quantized) contribution
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    cur_q, cur_s = q, scale.reshape(1)
    for _ in range(n - 1):
        new_q, new_s = torch.empty_like(cur_q), torch.empty_like(cur_s)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, cur_q, nxt, group),
            dist.P2POp(dist.isend, cur_s, nxt, group),
            dist.P2POp(dist.irecv, new_q, prv, group),
            dist.P2POp(dist.irecv, new_s, prv, group)])
        for r in reqs:
            r.wait()
        cur_q, cur_s = new_q, new_s
        acc = acc + _dequantize(cur_q, cur_s[0])
    return acc


def compressed_psum_pod(grads: PyTree, mesh, seed: int) -> PyTree:
    """Sum over the ``pod`` axis with the int8 wire format: a new tree,
    each leaf in its own type.  Leaves are summed within each pod already
    (the all-reduce over data and model); this is the inter-pod hop only.
    A mesh without ``pod`` returns ``grads`` as they are."""
    if "pod" not in mesh.axis_names:
        return grads
    group = mesh.group(("pod",))
    index = {id(g): i for i, g in enumerate(tree_leaves(grads))}

    def one(g):
        out = _ring_allreduce_int8(g.to(torch.float32).contiguous(),
                                   fold_in(seed, index[id(g)]), group)
        return out.to(g.dtype)

    return tree_map(one, grads)
