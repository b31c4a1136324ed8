"""Weights from the JAX package into the port.

``from_jax_params(np_params, cfg)`` takes the JAX parameter pytree of an
``attn_mlp`` model with its leaves already turned into NumPy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dict: the stacked ``layers`` axis becomes a list, matrices take
the compute dtype, norm scales stay f32.  No JAX is imported here.
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

    def leaf(a) -> torch.Tensor:
        arr = np.asarray(a, dtype=np.float32)
        t = torch.from_numpy(arr.copy()).to(dev)
        return t.to(wdt) if arr.ndim >= 2 else t

    def tree(node):
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return leaf(node)

    stacked = np_params["layers"]
    layers = []
    for i in range(cfg.layers):
        layers.append({blk: {k: leaf(np.asarray(v)[i]) for k, v in
                             sub.items()}
                       for blk, sub in stacked.items()})
    return {"embed": tree(np_params["embed"]), "layers": layers,
            "ln_f": tree(np_params["ln_f"])}
