"""Weights from the JAX package into the port.

``from_jax_params(np_params, cfg)`` takes the JAX parameter pytree of an
``attn_mlp``, ``attn_moe``, ``ssm`` or ``hybrid`` model, or of whisper's
encoder-decoder, with its leaves already turned into NumPy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dict: the stacked ``layers`` axis (``cfg.layers`` long) and the
encoder's ``enc_layers`` (``cfg.encoder.layers`` long) become lists, the
decoder's cross-attention ``lnx`` and ``xattn`` pass through with the rest
of each block, ``enc_ln_f`` as ``ln_f``; matrices (and the MoE expert stacks) take the compute
dtype, norm scales and the q/k/v biases stay f32, and so does the SSM decay
projection ``ssm.wa``, which the JAX layer runs in f32 whatever the compute
type.  Expert storage padded for the all-to-all schedule (more stored
experts than the config routes to) is refused, and so is a tree whose
encoder leaves the config does not expect, or whose stacks are not as long
as the config's layers.  No JAX is imported here.
"""
from __future__ import annotations

from typing import Any, Dict, List

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
    def stack(node, n: int, name: str) -> List[Dict[str, Any]]:
        depths = {np.shape(v)[0] for sub in node.values()
                  for v in sub.values()}
        if depths != {n}:
            raise ValueError(f"{name} stacked over {sorted(depths)} layers, "
                             f"config {cfg.name} has {n}")
        return [{blk: {k: leaf(np.asarray(v)[i],
                               keep_f32=(blk, k) == ("ssm", "wa"))
                       for k, v in sub.items()}
                 for blk, sub in node.items()} for i in range(n)]

    enc = ("enc_layers", "enc_ln_f")
    if cfg.encoder is None:
        extra = [k for k in enc if k in np_params] + [
            k for k in ("lnx", "xattn") if k in stacked]
        if extra:
            raise ValueError(f"encoder leaves {extra} in the tree, but "
                             f"config {cfg.name} has no encoder")
    out = {"embed": tree(np_params["embed"]),
           "layers": stack(stacked, cfg.layers, "layers"),
           "ln_f": tree(np_params["ln_f"])}
    if cfg.encoder is not None:
        missing = [k for k in enc if k not in np_params]
        if missing or "xattn" not in stacked:
            raise ValueError(f"config {cfg.name} has an encoder, the tree "
                             f"lacks {missing or ['xattn']}")
        out["enc_layers"] = stack(np_params["enc_layers"],
                                  cfg.encoder.layers, "enc_layers")
        out["enc_ln_f"] = tree(np_params["enc_ln_f"])
    return out
