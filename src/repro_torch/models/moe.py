"""Mixture-of-experts layer (the port of ``models/moe.py``): GShard-style
grouped dispatch with softmax top-k routing and capacity dropping.

Tokens are processed in groups of ``min(MOE_GROUP_SIZE, T)`` (the last one
padded with zero tokens, which route but are cut from the output), so the
dispatch and combine one-hot tensors stay (G, gsz, E, C).  The router runs
on K1 (``ops.matmul``, f32 out) from compute-dtype inputs and only the
softmax is f32, as in the JAX layer; the expert SwiGLU runs on K1's batched
entry (``ops.matmul_batched``), one launch a projection for all E experts
at their capacity of C token rows.  The one-hot dispatch and combine
contractions are plain ``torch.einsum``, as they are plain einsum outside
any Pallas kernel in the JAX layer.  The JAX layer's sharding constraints
are layout hints to GSPMD, which the port does not have; under a mesh the
``moe_a2a`` schedule (:mod:`.moe_a2a`) is the port's expert parallelism.

Under the ``moe_a2a`` flag an E >= 256 config stores its experts padded to
a multiple of 512 (:func:`a2a_padded_experts`), as the JAX init does; this
dense layer then runs the first E of them, as the JAX layer slices them.

While autograd records (``layers.recording``: a train step), the router
runs through ``MatmulFn`` (its backward K1 over K4 transposes, the logits
still f32) and the three expert products through ``BatchedMatmulFn`` (its
backward K1's batched entry over K4's batched transposes); the softmax,
the top-k, the capacity assignment, the dispatch and combine einsums and
the aux loss are PyTorch's own ops, differentiated as JAX differentiates
the JAX layer's: a dropped token carries no gradient through the experts.
Every serve path launches what it launched before.

Shapes (per call):
  x          (B, S, d)      -> tokens (G, gsz, d)
  router     (d, E)
  wi, wg     (E, d, f)      SwiGLU expert FFN
  wo         (E, f, d)
  dispatch   (G, gsz, E, C) combine weights; C = ceil(gsz*k*cf/E), >= 4

Routing ties break toward the lower expert index, as ``jax.lax.top_k``
does (a stable descending sort): zero padding tokens, for one, give every
expert the same probability.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.autograd import BatchedMatmulFn, MatmulFn
from .config import ModelConfig
from .layers import recording

Params = Dict[str, Any]

#: Token-group size of the grouped dispatch (the JAX layer's); the trace
#: derives the capacity-width expert matmul shapes from it.
MOE_GROUP_SIZE = 1024

# production mesh device counts the a2a layout must divide into
_A2A_PAD_TO = 512


def a2a_padded_experts(cfg: ModelConfig) -> int:
    """Stored expert count: under the 'moe_a2a' flag, E padded up to a
    multiple of the largest production mesh (512) when E >= 256, as in the
    JAX package; E otherwise (small-E archs pad at call time)."""
    E = cfg.moe.num_experts
    if "moe_a2a" in cfg.perf_flags and E >= 256:
        return -(-E // _A2A_PAD_TO) * _A2A_PAD_TO
    return E


def capacity(group_size: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Per-expert per-group token capacity (static)."""
    c = math.ceil(group_size * top_k * capacity_factor / num_experts)
    return max(4, c)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, equal values
    in the order of their index, as ``jax.lax.top_k`` gives them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              group_size: int = MOE_GROUP_SIZE
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), Switch load-balance loss (f32 scalar))."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    T = B * S
    gsz = min(group_size, T)
    G = -(-T // gsz)
    Tp = G * gsz
    C = capacity(gsz, E, k, m.capacity_factor)
    xt = x.reshape(T, d).contiguous()

    # ---- routing: a zero padding token has zero logits ---------------------
    logits = router_logits(p["router"], xt)                       # (T, E) f32
    if Tp != T:
        xt = F.pad(xt, (0, 0, 0, Tp - T))
        logits = F.pad(logits, (0, 0, 0, Tp - T))
    xg = xt.reshape(G, gsz, d)
    dispatch, combine, probs, onehot = route(logits.reshape(G, gsz, E), k, C)

    # ---- expert SwiGLU: each projection one batched K1 launch ---------------
    xin = torch.einsum("gtec,gtd->egcd", dispatch.to(x.dtype), xg)
    xin = xin.reshape(E, G * C, d).contiguous()
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    if wi.shape[0] != E:                    # a2a-padded storage, dense path
        wi, wg, wo = wi[:E], wg[:E], wo[:E]
    out = experts_swiglu(xin, wi, wg, wo)
    y = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype),
                     out.reshape(E, G, C, d))
    y = y.reshape(Tp, d)[:T].reshape(B, S, d)

    # ---- Switch aux loss: E * sum_e f_e * p_e -------------------------------
    frac_tokens = onehot[:, :, 0, :].mean(dim=(0, 1))           # top-1 share
    frac_probs = probs.mean(dim=(0, 1))
    return y, E * (frac_tokens * frac_probs).sum()


def _matmul(a, b, fn, op):
    return fn.apply(a, b) if recording(a, b) else op(a, b)


def router_logits(router: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """(T, E) f32 logits of tokens ``xt`` (T, d) on K1, from compute-dtype
    inputs (``MatmulFn`` while autograd records)."""
    return _matmul(xt, router.to(xt.dtype), MatmulFn, ops.matmul)


def route(logits: torch.Tensor, k: int, C: int):
    """GShard routing of groups of logits (G, gsz, E): (dispatch, combine)
    (G, gsz, E, C) f32, the probabilities and the top-k one-hot (G, gsz, k,
    E); capacity C a group and expert, token-major priority."""
    G, gsz, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)                                  # (G,gsz,k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- capacity assignment (GShard), token-major priority -----------------
    experts = torch.arange(E, device=logits.device)
    onehot = (idx[..., None] == experts).float()                 # (G,gsz,k,E)
    flat = onehot.reshape(G, gsz * k, E)
    pos = (flat.cumsum(1) - flat).reshape(G, gsz, k, E)
    pos_k = (pos * onehot).sum(-1)                                # (G,gsz,k)
    fits = (pos_k < C) & (onehot.sum(-1) > 0)
    slots = torch.arange(C, device=logits.device)
    pos_oh = (pos_k.long()[..., None] == slots).float() * fits[..., None]
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot, pos_oh)    # (G,gsz,E,C)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot, pos_oh, gates)
    return dispatch, combine, probs, onehot


def experts_swiglu(xin: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                   wo: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their rows ``xin`` (E, M, d): three launches
    of K1's batched entry (``BatchedMatmulFn`` while autograd records),
    (E, M, d) out in ``xin``'s type."""
    def expert(a, w):
        return _matmul(a, w.to(xin.dtype), BatchedMatmulFn,
                       ops.matmul_batched).to(xin.dtype)

    h = expert(xin, wi)
    g = expert(xin, wg)
    return expert((F.silu(g) * h).contiguous(), wo)
