"""Functional model layers on tensors (the port of ``models/layers.py``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts (``wq`` is [d_model, heads·hd], ...), so a JAX pytree converts leaf
for leaf (:mod:`repro_torch.convert`).  Every projection goes through
``ops.matmul`` (K1) and every attention core through ``ops.flash_attention``
(K2): the design the JAX layers state and their warm set traces, although
their forward is einsum on every backend (ROADMAP F3).  The port is held
against that einsum math.

Only the dense ``attn_mlp`` block of this slice is here: RMSNorm, RoPE,
attention (no-cache and paged paths), the SwiGLU MLP, embed and unembed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig

Params = Dict[str, Any]


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] through K1; the result takes x's type, as the
    JAX einsum over ``w.astype(x.dtype)`` does."""
    lead = x.shape[:-1]
    y = ops.matmul(x.reshape(-1, x.shape[-1]).contiguous(), w.to(x.dtype))
    return y.to(x.dtype).reshape(*lead, w.shape[1])


# ---------------------------------------------------------------------------
# RMSNorm, RoPE
# ---------------------------------------------------------------------------

def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S).  Angles and the rotation in
    f32, as the JAX layer computes them without ``rope_compute``."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + causal/window masks; no cache or paged KV pool)
# ---------------------------------------------------------------------------

def _core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """One sequence's attention through K2: q (Sq, nh, hd), k/v (Sk, nk, hd)
    with Sq <= Sk, ends aligned.  KV heads are broadcast to the query heads
    here (query head h reads kv head h // group, the JAX grouping)."""
    group = cfg.heads // cfg.kv_heads
    qh = q.permute(1, 0, 2).contiguous()
    kh = k.permute(1, 0, 2).repeat_interleave(group, dim=0).contiguous()
    vh = v.permute(1, 0, 2).repeat_interleave(group, dim=0).contiguous()
    out = ops.flash_attention(qh, kh, vh, causal=True, window=cfg.window)
    return out.permute(1, 0, 2)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_index: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              spans: Optional[Sequence[Tuple[int, int]]] = None,
              ) -> torch.Tensor:
    """Causal self-attention over x (B, Sq, d).

    Without ``cache`` every row attends over its own Sq tokens (positions
    0..Sq-1).  With a paged ``cache`` — block pools {"k","v"} of shape
    (num_blocks, page_size, nk, hd), written **in place** — this call's K/V
    are scattered into the rows' physical blocks at logical positions
    ``cache_index + i`` (``block_tables`` (B, nblk) maps logical to
    physical blocks), then each row ``b`` of ``spans`` = [(b, length), ...]
    gathers only its first ``ceil(length / page_size)`` blocks, cut to
    ``length`` positions, and attends over them with the queries' ends
    aligned to position ``length - 1``.  Rows not in ``spans`` (not
    decoding) get a zero output and are never read: garbage-block positions
    never enter an attention."""
    B, Sq, d = x.shape
    nh, nk, hd = cfg.heads, cfg.kv_heads, cfg.hd
    q = proj(x, p["wq"])
    k = proj(x, p["wk"])
    v = proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = rope(q.reshape(B, Sq, nh, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, Sq, nk, hd), positions, cfg.rope_theta)
    v = v.reshape(B, Sq, nk, hd)

    if cache is None:
        out = torch.stack([_core(q[b], k[b], v[b], cfg) for b in range(B)])
    else:
        ck, cv = cache["k"], cache["v"]
        ps = ck.shape[1]
        ptok = cache_index.reshape(-1, 1).expand(B, 1) + torch.arange(
            Sq, device=x.device)[None]
        phys = torch.gather(block_tables, 1, ptok // ps)
        slot = ptok % ps
        ck[phys, slot] = k.to(ck.dtype)
        cv[phys, slot] = v.to(cv.dtype)
        out = torch.zeros_like(q)
        for b, length in spans:
            blocks = block_tables[b, :-(-length // ps)]
            ka = ck[blocks].reshape(-1, nk, hd)[:length].to(x.dtype)
            va = cv[blocks].reshape(-1, nk, hd)[:length].to(x.dtype)
            out[b] = _core(q[b], ka, va, cfg)
    return proj(out.reshape(B, Sq, nh * hd), p["wo"])


# ---------------------------------------------------------------------------
# SwiGLU MLP, embedding
# ---------------------------------------------------------------------------

def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = proj(x, p["wi"])
    g = proj(x, p["wg"])
    return proj(F.silu(g) * h, p["wo"])


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p["tok"][tokens].to(dtype)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    return proj(x, p["out"])
