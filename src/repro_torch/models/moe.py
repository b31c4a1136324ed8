"""Mixture-of-experts layer (the port of ``models/moe.py``): GShard-style
grouped dispatch with softmax top-k routing and capacity dropping.

Tokens are processed in groups of ``min(MOE_GROUP_SIZE, T)`` (the last one
padded with zero tokens, which route but are cut from the output), so the
dispatch and combine one-hot tensors stay (G, gsz, E, C).  The router runs
on K1 (``ops.matmul``, f32 out) from compute-dtype inputs and only the
softmax is f32, as in the JAX layer; the expert SwiGLU runs one launch a
projection for all E experts at their capacity of C token rows
(``ops.matmul_batched``: K1b in bf16, whose output is bf16; K1's batched
entry in f32).  The one-hot dispatch and combine
contractions are plain ``torch.einsum``, as they are plain einsum outside
any Pallas kernel in the JAX layer.

Under a mesh (a mesh step) the layer is expert-parallel as JAX's rules
shard it: the experts over ``data``, their ``ff`` over ``model``, each
rank's x its rows of the microbatch.  GSPMD keeps the one-device meaning,
so the layer gives what it gives over the whole microbatch: the group
size, the capacity and the padding come from the microbatch's tokens over
every batch rank.  Where the rank's rows are whole groups, it routes them
itself, and one all-to-all over ``data`` brings every group's rows of its
experts to each rank (and a second one the outputs home); otherwise every
rank gathers the microbatch's rows, routes all of them as one device
does, runs its experts over every group and sums the experts' outputs
back onto each rank's rows (:func:`~repro_torch.distributed.comm.
scatter_sum`).  The experts' SwiGLU is column- then row-parallel over
``model`` inside each expert.  The load-balance statistics are the whole
microbatch's on every rank, so every rank's loss holds the whole aux
loss.  The ``moe_a2a`` schedule (:mod:`.moe_a2a`) is the other expert
parallelism, under its flag.

Under the ``moe_a2a`` flag an E >= 256 config stores its experts padded to
a multiple of 512 (:func:`a2a_padded_experts`), as the JAX init does; this
dense layer then runs the first E of them, as the JAX layer slices them.

While autograd records (``layers.recording``: a train step), the router
runs through ``MatmulFn`` (its backward K1 over K4 transposes, the logits
still f32) and the three expert products through ``BatchedMatmulFn`` (its
backward K1b over the stored operands read transposed in bf16, K1's
batched entry over K4's batched transposes in f32); the softmax,
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

from ..distributed import sharding as dist
from ..distributed.comm import (all_reduce_sum, all_to_all, copy_to, gather,
                                reduce_from, scatter_sum)
from ..kernels import ops
from ..kernels.autograd import BatchedMatmulFn, MatmulFn
from .config import ModelConfig
from .layers import model_split, recording

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


class _Parts:
    """Where the current mesh puts a dense MoE layer (every size 1 and
    every group None without a mesh): its batch ranks (``n_b``, this
    rank's index ``b``, their group), its expert shards over ``data``
    (``n_e``, the rank's first expert ``e0``, their group) and its
    ``model`` group where the experts' ``ff`` is split."""

    def __init__(self, p: Params, cfg: ModelConfig):
        E = cfg.moe.num_experts
        mesh = dist.current_mesh()
        self.n_b, self.b, self.batch = 1, 0, None
        self.n_e, self.e0, self.experts, self.model = 1, 0, None, None
        held = p["wi"].shape[0]
        if mesh is not None:
            axes = dist.batch_axes(mesh)
            self.n_b, self.b = mesh.axis_size(axes), mesh.axis_index(axes)
            if self.n_b > 1:
                self.batch = mesh.group(axes)
            if held < E:
                self.n_e = E // held
                if held * self.n_e != E or mesh.shape.get("data") != self.n_e:
                    raise ValueError(f"{held} of {E} experts a rank: not the "
                                     "part the 'expert' rule gives")
                self.e0 = mesh.coords()["data"] * held
                self.experts = mesh.group(("data",))
            if model_split(p["wi"], 2, cfg.moe.d_ff_expert) > 1:
                self.model = mesh.group(("model",))


def moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              group_size: int = MOE_GROUP_SIZE
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d), Switch load-balance loss (f32 scalar));
    under a mesh x is the rank's rows and ``p``'s experts its part, and
    the loss the whole microbatch's (the module's docstring)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    at = _Parts(p, cfg)
    T_l = B * S                               # the rank's tokens
    T = T_l * at.n_b                          # the microbatch's
    gsz = min(group_size, T)
    C = capacity(gsz, E, k, m.capacity_factor)
    xt = x.reshape(T_l, d).contiguous()
    whole = at.n_b > 1 and T_l % gsz != 0     # groups straddle the ranks
    if whole:
        xt = gather(xt, 0, at.batch)          # backward: a reduce-scatter
    Tr = xt.shape[0]                          # the tokens routed here
    G = -(-Tr // gsz)
    Tp = G * gsz

    # ---- routing: a zero padding token has zero logits ---------------------
    logits = router_logits(p["router"], xt)                      # (Tr, E) f32
    if Tp != Tr:
        xt = F.pad(xt, (0, 0, 0, Tp - Tr))
        logits = F.pad(logits, (0, 0, 0, Tp - Tr))
    xg = xt.reshape(G, gsz, d)
    dispatch, combine, probs, onehot = route(logits.reshape(G, gsz, E), k, C)

    # ---- expert SwiGLU: each projection one batched K1 launch ---------------
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    if wi.shape[0] > E:                     # a2a-padded storage, dense path
        wi, wg, wo = wi[:E], wg[:E], wo[:E]
    E_l = wi.shape[0]
    if whole:                               # the rank's experts, all groups
        dispatch = dispatch[:, :, at.e0:at.e0 + E_l]
        combine = combine[:, :, at.e0:at.e0 + E_l]
    xin = torch.einsum("gtec,gtd->egcd", dispatch.to(x.dtype), xg)
    xin = xin.reshape(xin.shape[0], G * C, d).contiguous()
    n_x = at.n_e if not whole else 1          # expert shards to exchange
    if n_x > 1:
        # chunk s of the expert axis to expert rank s: every group's rows
        # of the rank's E_l experts, [source rank, expert, ...]
        xin = all_to_all(xin, at.experts).reshape(n_x, E_l, G * C, d)
        xin = xin.transpose(0, 1).reshape(E_l, n_x * G * C, d)
    if at.model is not None:
        xin = copy_to(xin, at.model)
    out = experts_swiglu(xin, wi, wg, wo)
    if at.model is not None:
        out = reduce_from(out, at.model)
    if n_x > 1:
        out = out.reshape(E_l, n_x, G * C, d).transpose(0, 1)
        out = all_to_all(out, at.experts)
    y = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype),
                     out.reshape(-1, G, C, d))
    y = y.reshape(Tp, d)[:Tr]
    if whole:                                 # the rank's rows of the sum
        y = _rows(y, at)

    # ---- Switch aux loss: E * sum_e f_e * p_e -------------------------------
    frac_tokens = onehot[:, :, 0, :].mean(dim=(0, 1))           # top-1 share
    frac_probs = probs.mean(dim=(0, 1))
    if at.n_b > 1 and not whole:              # the microbatch's means
        stats = all_reduce_sum(torch.stack([frac_tokens, frac_probs]),
                               at.batch) / at.n_b
        frac_tokens, frac_probs = stats[0], stats[1]
    return y.reshape(B, S, d), E * (frac_tokens * frac_probs).sum()


def _rows(y: torch.Tensor, at: _Parts) -> torch.Tensor:
    """The rank's rows of the microbatch's output, summed over the expert
    shards ``y`` (every row, the rank's experts' part) is one of: within
    the rank's pod, one reduce-scatter over ``data``."""
    if at.n_e == 1:
        n = y.shape[0] // at.n_b
        return y.narrow(0, at.b * n, n)
    n = y.shape[0] * at.n_e // at.n_b         # a pod's rows
    return scatter_sum(y.narrow(0, at.b // at.n_e * n, n), 0, at.experts)


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
    of ``ops.matmul_batched`` (``BatchedMatmulFn`` while autograd records),
    (E, M, d) out in ``xin``'s type: K1b returns bf16 for bf16 rows, K1's
    batched entry f32 for f32 rows."""
    def expert(a, w):
        return _matmul(a, w.to(xin.dtype), BatchedMatmulFn,
                       ops.matmul_batched)

    h = expert(xin, wi)
    g = expert(xin, wg)
    return expert((F.silu(g) * h).contiguous(), wo)
