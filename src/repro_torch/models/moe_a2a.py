"""Hand-written all-to-all MoE dispatch (the port of
``repro.models.moe_a2a``): the ``moe_a2a`` flag under a mesh.

The JAX module writes the expert-parallel schedule with ``shard_map`` and
``lax.all_to_all``; the port writes the same schedule over
``torch.distributed``, rank r doing what JAX's device r does:

* experts are spread over every rank of the ("data", "model") group,
  padded up to a multiple of its size (phantom experts receive no tokens;
  storage padded under the flag is used as it is).  Each rank holds its
  E_l = E_pad / n experts: the chunk r of the padded stack
  (:func:`repro_torch.launch.specs.expert_spec`);
* each rank routes its own token groups: its data shard's groups, split
  over the ``model`` ranks of that shard, ``gsz = min(group_size, T // n)``
  tokens a group, T the whole batch's tokens.  The router runs on K1;
* one all-to-all over the group exchanges the dispatched tensor, expert
  axis first, for every group's rows of this rank's experts, whose SwiGLU
  runs on K1's batched entry over E_l experts at M = G·C rows (their
  backward K1's batched entry over K4's); a second all-to-all brings the
  outputs home and the combine is local;
* the load-balance statistics are averaged over the group (``pmean``),
  and the ``model`` ranks of one data shard gather their groups back, so
  the activations outside the block stay the data shard's.

Every collective is an autograd function whose backward is its adjoint
(:mod:`repro_torch.distributed.comm`), and the exchange runs at every
group size: at one rank it still goes through the backend's all-to-all.
Ranks along ``model`` compute one loss together (the model's tensor
parallelism), so there the block's input and router enter through
``copy_to`` (each rank routes only its groups), the groups come back
through ``reduce_from`` of the rank's rows in place, and the statistics
sum over ``model`` through ``reduce_from`` before the data ranks' sum.

Over more than one pod the schedule is JAX's ``shard_map``, whose specs
name only ("data", "model"): the token groups are the whole batch's (T =
B·S over every pod), they lie over ("data", "model") and each pod
computes all of them, the experts lie over ("data", "model") and are
replicated over ``pod`` (their gradients sum over it as any replicated
leaf's).  The groups a rank routes are then not its own rows: the ranks
along the batch axes ("pod", "data") of one ``model`` coordinate gather
the batch (``all_gather``, whose adjoint is a reduce-scatter) and each
takes the groups of its (data, model) index; after the exchange the
outputs come home over ``model`` (``reduce_from``, as in one pod) and
then over ``data`` within the pod (``all_gather``), and each rank keeps
its own rows.  A pod's copy of a group is thus read back only by that
pod's rows: each row's gradient enters once, through its own pod, and
each pod's copy of the statistics, like every rank's loss, is divided by
the row shards as before.  On one pod every launch and bit is as it was.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed import sharding as dist
from ..distributed.comm import (all_gather, all_reduce_sum, all_to_all,
                                copy_to, reduce_from)
from .config import ModelConfig
from .moe import (MOE_GROUP_SIZE, capacity, experts_swiglu, route,
                  router_logits)

Params = Dict[str, Any]


def a2a_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the expert all-to-all runs over."""
    return tuple(a for a in ("data", "model") if a in mesh.axis_names)


def a2a_active(cfg: ModelConfig, mesh) -> bool:
    """Whether ``cfg`` takes the schedule on ``mesh``: the flag on an
    ``attn_moe`` config and a mesh with ``data`` (its experts are then
    held sharded)."""
    return (cfg.block == "attn_moe" and "moe_a2a" in cfg.perf_flags
            and mesh is not None and "data" in mesh.axis_names)


def moe_block_a2a(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  group_size: int = MOE_GROUP_SIZE
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer over the current mesh: ``x`` (B, S, d) is this rank's
    data shard, ``p``'s expert stacks its E_l experts; returns (output
    (B, S, d), aux load-balance loss (f32 scalar, the group's))."""
    mesh = dist.current_mesh()
    if mesh is None or "data" not in mesh.axis_names:
        raise ValueError("moe_block_a2a needs a current mesh with a 'data' "
                         "axis (distributed.use_mesh_rules)")
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    axes = a2a_axes(mesh)
    n_dev = mesh.axis_size(axes)
    n_model = mesh.shape.get("model", 1)
    E_l = p["wi"].shape[0]
    E_pad = E_l * n_dev
    if E_pad < E:
        raise ValueError(f"{E_l} experts a rank over {n_dev} ranks hold "
                         f"fewer than the {E} routed")

    T_l = B * S                           # the rank's rows' tokens
    n_pod = mesh.shape.get("pod", 1)
    T = T_l * mesh.shape["data"] * n_pod
    gsz = min(group_size, max(1, T // n_dev))
    G = T // gsz
    if T % gsz or G % n_dev:
        raise ValueError(f"moe_a2a needs tokens to tile over {n_dev} "
                         f"ranks: T={T} gsz={gsz}")
    G_l = G // n_dev
    C = capacity(gsz, E, k, m.capacity_factor)
    j = mesh.coords()["model"] if "model" in axes else 0
    router = p["router"]
    if n_model > 1:
        mgroup = mesh.group(("model",))
        x, router = copy_to(x, mgroup), copy_to(router, mgroup)
    if n_pod > 1:       # the batch, then the groups of (data, model) index
        xg = all_gather(x.reshape(T_l, d), mesh.group(("pod", "data")))
        i = mesh.axis_index(axes)
        xt = xg[i * G_l * gsz:(i + 1) * G_l * gsz].contiguous()
    else:
        xt = x.reshape(T_l, d)[j * G_l * gsz:(j + 1) * G_l * gsz]
        xt = xt.contiguous()

    dispatch, combine, probs, onehot = route(
        router_logits(router, xt).reshape(G_l, gsz, E), k, C)
    xg = xt.reshape(G_l, gsz, d)
    xin = torch.einsum("gtec,gtd->egcd", dispatch.to(x.dtype), xg)
    if E_pad > E:                          # phantom experts: no tokens
        xin = F.pad(xin, (0, 0, 0, 0, 0, 0, 0, E_pad - E))
    # exchange: chunk s of the expert axis to rank s; every rank then holds
    # all groups' rows of its E_l experts, [source rank, expert, ...]
    group = mesh.group(axes)
    xin = all_to_all(xin, group).reshape(n_dev, E_l, G_l * C, d)
    xin = xin.transpose(0, 1).reshape(E_l, n_dev * G_l * C, d)
    out = experts_swiglu(xin, p["wi"], p["wg"], p["wo"])
    out = out.reshape(E_l, n_dev, G_l * C, d).transpose(0, 1)
    # inverse exchange: outputs come home, experts in order again
    out = all_to_all(out, group).reshape(E_pad, G_l, C, d)[:E]
    y = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype), out)
    y = y.reshape(G_l * gsz, d)
    stats = torch.stack([onehot[:, :, 0, :].mean(dim=(0, 1)),
                         probs.mean(dim=(0, 1))])
    if n_model > 1:
        rows = G_l * gsz
        y = reduce_from(F.pad(y, (0, 0, j * rows, (n_model - 1 - j) * rows)),
                        mgroup)
        stats = reduce_from(stats, mgroup)
        group = mesh.group(("data",))
    # load-balance stats: the group's means (pmean)
    stats = all_reduce_sum(stats, group) / n_dev
    aux = E * (stats[0] * stats[1]).sum()
    if n_pod > 1:       # the pod's outputs, then the rank's own rows
        y = all_gather(y, mesh.group(("data",)))
        b = mesh.axis_index(("pod", "data"))
        y = y[b * T_l:(b + 1) * T_l]
    return y.reshape(B, S, d), aux
