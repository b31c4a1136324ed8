"""Weights from the JAX package into the port.

``from_jax_params(np_params, cfg)`` takes the JAX parameter pytree of an
``attn_mlp``, ``attn_moe``, ``ssm`` or ``hybrid`` model with its leaves
already turned into NumPy arrays (for example ``jax.tree.map(np.asarray,
params)``) and returns the port's parameter dict: the stacked ``layers``
axis becomes a list, matrices (and the MoE expert stacks) take the compute
dtype, norm scales and the q/k/v biases stay f32, and so does the SSM decay
projection ``ssm.wa``, which the JAX layer runs in f32 whatever the compute
type.  Expert storage padded for the all-to-all schedule (more stored
experts than the config routes to) is refused.  No JAX is imported here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device, torch_dtype
from .models.config import ModelConfig


def from_jax_params(np_params: Dict[str, Any], cfg: ModelConfig, *,
                    device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    wdt = torch_dtype(cfg.dtype)

    def leaf(a, keep_f32: bool = False) -> torch.Tensor:
        arr = np.asarray(a, dtype=np.float32)
        t = torch.from_numpy(arr.copy()).to(dev)
        return t.to(wdt) if arr.ndim >= 2 and not keep_f32 else t

    def tree(node):
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return leaf(node)

    stacked = np_params["layers"]
    if "moe" in stacked:
        stored = np.shape(stacked["moe"]["wi"])[1]
        if stored != cfg.moe.num_experts:
            raise NotImplementedError(
                f"{stored} stored experts for {cfg.moe.num_experts} routed "
                f"(config {cfg.name}): the all-to-all padded expert storage "
                "of 'moe_a2a' is not ported yet")
    layers = []
    for i in range(cfg.layers):
        layers.append({blk: {k: leaf(np.asarray(v)[i],
                                     keep_f32=(blk, k) == ("ssm", "wa"))
                             for k, v in sub.items()}
                       for blk, sub in stacked.items()})
    return {"embed": tree(np_params["embed"]), "layers": layers,
            "ln_f": tree(np_params["ln_f"])}
