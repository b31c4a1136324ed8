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
type.  Expert storage padded for the all-to-all schedule
(:func:`~repro_torch.models.moe.a2a_padded_experts` stored) passes through
as it is; any other stored count is refused, and so is a tree whose
encoder leaves the config does not expect, or whose stacks are not as long
as the config's layers.  No JAX is imported here.

``train_params_from_jax`` is the training form: the JAX tree leaf for leaf,
``layers`` and ``enc_layers`` still stacked and every leaf f32 (the JAX
``param_dtype``), so the optimizer state, the global norm and checkpoint
names line up with the JAX ones without any translation.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .device import DeviceLike, resolve_device, torch_dtype
from .models.config import ModelConfig
from .models.moe import a2a_padded_experts


def _check(np_params: Dict[str, Any], cfg: ModelConfig) -> None:
    """Refuse a tree the config does not describe: a stored expert count
    that is neither E nor the ``moe_a2a`` padded one, encoder leaves the
    config lacks (or lacks them), stacks of the wrong depth."""
    stacked = np_params["layers"]
    if "moe" in stacked:
        stored = np.shape(stacked["moe"]["wi"])[1]
        if stored not in (cfg.moe.num_experts, a2a_padded_experts(cfg)):
            raise ValueError(
                f"{stored} stored experts for {cfg.moe.num_experts} routed "
                f"(config {cfg.name}): neither E nor the 'moe_a2a' padded "
                f"count {a2a_padded_experts(cfg)}")
    enc = ("enc_layers", "enc_ln_f")
    if cfg.encoder is None:
        extra = [k for k in enc if k in np_params] + [
            k for k in ("lnx", "xattn") if k in stacked]
        if extra:
            raise ValueError(f"encoder leaves {extra} in the tree, but "
                             f"config {cfg.name} has no encoder")
    else:
        missing = [k for k in enc if k not in np_params]
        if missing or "xattn" not in stacked:
            raise ValueError(f"config {cfg.name} has an encoder, the tree "
                             f"lacks {missing or ['xattn']}")
    stacks = [("layers", cfg.layers)]
    if cfg.encoder is not None:
        stacks.append(("enc_layers", cfg.encoder.layers))
    for name, n in stacks:
        depths = {np.shape(v)[0] for sub in np_params[name].values()
                  for v in sub.values()}
        if depths != {n}:
            raise ValueError(f"{name} stacked over {sorted(depths)} layers, "
                             f"config {cfg.name} has {n}")


def from_jax_params(np_params: Dict[str, Any], cfg: ModelConfig, *,
                    device: DeviceLike = None) -> Dict[str, Any]:
    _check(np_params, cfg)
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

    def stack(node, n: int) -> List[Dict[str, Any]]:
        return [{blk: {k: leaf(np.asarray(v)[i],
                               keep_f32=(blk, k) == ("ssm", "wa"))
                       for k, v in sub.items()}
                 for blk, sub in node.items()} for i in range(n)]

    out = {"embed": tree(np_params["embed"]),
           "layers": stack(np_params["layers"], cfg.layers),
           "ln_f": tree(np_params["ln_f"])}
    if cfg.encoder is not None:
        out["enc_layers"] = stack(np_params["enc_layers"], cfg.encoder.layers)
        out["enc_ln_f"] = tree(np_params["enc_ln_f"])
    return out


def train_params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig, *,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX training tree as the port's training state: the same nested
    dicts, stacks kept, every leaf an f32 tensor on ``device``."""
    _check(np_params, cfg)
    dev = resolve_device(device)

    def tree(node):
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return torch.from_numpy(np.asarray(node, dtype=np.float32).copy()
                                ).to(dev)

    return tree(np_params)
