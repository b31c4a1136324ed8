"""Model assembly (the port of ``models/transformer.py``, ``attn_mlp`` only).

Parameters are a dict ``{"embed": {"tok", "out"}, "layers": [per-layer
dicts], "ln_f": {"scale"}}``; the JAX package stacks layers on a leading
axis and scans them, the port keeps a list and loops.  Weights (>= 2-D) are
held in the compute dtype, norm scales in f32: the JAX forward casts every
weight to ``x.dtype`` before use, so the numbers are the same and a bf16
model takes half the memory.

The paged serving functions update the KV pool **in place** (the JAX ones
return a new pool); they still return it, so callers read the same.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, torch_dtype
from . import layers as L
from .config import ModelConfig

Params = Dict[str, Any]


def _check_block(cfg: ModelConfig) -> None:
    if cfg.block != "attn_mlp" or cfg.encoder is not None:
        raise NotImplementedError(
            f"block {cfg.block!r} (config {cfg.name}) is not ported yet: "
            "this slice serves attn_mlp decoders")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card unless the caller passes ``"cpu"``): normal / sqrt(fan_in) for
    matrices, 0.02·normal for the token table, ones for norm scales — the
    JAX package's distributions, not its numbers."""
    _check_block(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    wdt = _dtype(cfg)

    def mat(*shape, scale=None):
        w = torch.randn(shape, generator=g, device=dev, dtype=wdt)
        return w.mul_(scale if scale is not None
                      else 1.0 / math.sqrt(max(1, shape[0])))

    def norm():
        return {"scale": torch.ones(cfg.d_model, dtype=torch.float32,
                                    device=dev)}

    d, f, nh, nk, hd = cfg.d_model, cfg.d_ff, cfg.heads, cfg.kv_heads, cfg.hd
    layers = []
    for _ in range(cfg.layers):
        attn = {"wq": mat(d, nh * hd), "wk": mat(d, nk * hd),
                "wv": mat(d, nk * hd), "wo": mat(nh * hd, d)}
        if cfg.qkv_bias:
            for name, n in (("bq", nh * hd), ("bk", nk * hd),
                            ("bv", nk * hd)):
                attn[name] = torch.zeros(n, dtype=torch.float32, device=dev)
        layers.append({"ln1": norm(), "attn": attn, "ln2": norm(),
                       "mlp": {"wi": mat(d, f), "wg": mat(d, f),
                               "wo": mat(f, d)}})
    return {"embed": {"tok": mat(cfg.vocab, d, scale=0.02),
                      "out": mat(d, cfg.vocab)},
            "layers": layers, "ln_f": norm()}


def _device(params: Params) -> torch.device:
    return params["embed"]["tok"].device


def _block(lp: Params, x: torch.Tensor, cfg: ModelConfig, **attn_kw
           ) -> torch.Tensor:
    x = x + L.attention(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                        cfg, **attn_kw)
    return x + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps))


def _long(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.long)
    return torch.tensor(np.asarray(x), dtype=torch.long, device=dev)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, tokens
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward: tokens (B, S) -> (logits (B, S, V),
    aux loss 0)."""
    _check_block(cfg)
    dev = _device(params)
    tokens = _long(tokens, dev)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, _dtype(cfg))
    positions = torch.arange(S, device=dev)
    for lp in params["layers"]:
        x = _block(lp, x, cfg, positions=positions)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x), torch.zeros((), device=dev)


# ---------------------------------------------------------------------------
# Paged (block-pool) serving path
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_blocks: int, page_size: int,
                     batch: int, dtype: torch.dtype = torch.bfloat16, *,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Block-pool KV cache {"k", "v"} of shape (layers, num_blocks,
    page_size, kv_heads, hd), bf16 by default as in the JAX package.  Block
    0 is the garbage block; ``batch`` is kept for signature parity (per-slot
    SSM state is not ported yet)."""
    _check_block(cfg)
    dev = resolve_device(device)
    shape = (cfg.layers, num_blocks, page_size, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def paged_copy_block(cache: Dict[str, torch.Tensor], src: int,
                     dst: int) -> Dict[str, torch.Tensor]:
    """Copy physical block ``src`` into ``dst`` in every layer (in place)."""
    for key in ("k", "v"):
        cache[key][:, int(dst)] = cache[key][:, int(src)]
    return cache


def paged_prefill_chunk(params: Params, cfg: ModelConfig, tokens,
                        cache: Dict[str, torch.Tensor], cache_index: int,
                        block_table, slot: int = 0
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One chunk of a paged prefill: ``tokens`` (1, C) at logical offset
    ``cache_index`` of the sequence whose block table is ``block_table``
    (1, nblk).  The chunk attends over keys 0 .. cache_index + C - 1, so end
    alignment reproduces the causal mask of the JAX layer.  Returns
    (last-token logits (1, V), cache)."""
    dev = _device(params)
    tokens = _long(tokens, dev)
    start = int(cache_index)
    C = tokens.shape[1]
    x = L.embed(params["embed"], tokens, _dtype(cfg))
    positions = start + torch.arange(C, device=dev)
    bt = _long(block_table, dev)
    idx = torch.tensor([start], dtype=torch.long, device=dev)
    for i, lp in enumerate(params["layers"]):
        x = _block(lp, x, cfg, positions=positions,
                   cache={"k": cache["k"][i], "v": cache["v"][i]},
                   cache_index=idx, block_tables=bt, spans=[(0, start + C)])
    x = L.rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache


def paged_decode_step(params: Params, cfg: ModelConfig, tokens,
                      cache: Dict[str, torch.Tensor], cache_index,
                      block_tables, *, active=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over the paged pool: ``tokens`` (B, 1) with per-row
    ``cache_index`` (B,) and ``block_tables`` (B, nblk), both host arrays.
    ``active`` (B,) bool marks the decoding rows (default: all).  Rows not
    decoding write the garbage block, as in the JAX step, and skip the
    attention read; their logits are meaningless and ignored."""
    dev = _device(params)
    tokens = _long(tokens, dev)
    B = tokens.shape[0]
    host_idx = np.asarray(cache_index).reshape(B)
    rows = (range(B) if active is None
            else np.flatnonzero(np.asarray(active)).tolist())
    spans = [(int(b), int(host_idx[b]) + 1) for b in rows]
    idx = _long(host_idx, dev)
    bt = _long(block_tables, dev)
    x = L.embed(params["embed"], tokens, _dtype(cfg))
    positions = idx[:, None]
    for i, lp in enumerate(params["layers"]):
        x = _block(lp, x, cfg, positions=positions,
                   cache={"k": cache["k"][i], "v": cache["v"][i]},
                   cache_index=idx, block_tables=bt, spans=spans)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache
