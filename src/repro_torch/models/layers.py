"""Functional model layers on tensors (the port of ``models/layers.py``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts (``wq`` is [d_model, heads·hd], ...), so a JAX pytree converts leaf
for leaf (:mod:`repro_torch.convert`).  Every projection goes through
``ops.matmul`` (K1), every attention core through ``ops.flash_attention``
or, over the paged pool, ``ops.paged_attention`` (K2), and every SSD core
through ``ops.ssd_scan`` (K3): the design the JAX
layers state and their warm set traces, although their forward is einsum
on every backend (ROADMAP F3).  The port is held against that einsum math.

The layers of the ported blocks (``attn_mlp``, ``ssm``, ``hybrid``):
RMSNorm, RoPE, attention (no-cache and paged paths), the Mamba-2 SSD block,
the SwiGLU MLP, embed and unembed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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
    with Sq <= Sk, ends aligned.  K2 takes the nk KV heads as they are and
    query head h reads kv head h // (nh/nk), the JAX grouping; nothing is
    broadcast."""
    qh = q.permute(1, 0, 2).contiguous()
    kh = k.permute(1, 0, 2).contiguous()
    vh = v.permute(1, 0, 2).contiguous()
    out = ops.flash_attention(qh, kh, vh, causal=True, window=cfg.window)
    return out.permute(1, 0, 2)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_index: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              lengths: Optional[torch.Tensor] = None,
              ) -> torch.Tensor:
    """Causal self-attention over x (B, Sq, d).

    Without ``cache`` every row attends over its own Sq tokens (positions
    0..Sq-1).  With a paged ``cache`` — block pools {"k","v"} of shape
    (num_blocks, page_size, nk, hd), written **in place** — this call's K/V
    are scattered into the rows' physical blocks at logical positions
    ``cache_index + i`` (``block_tables`` (B, nblk) int32 maps logical to
    physical blocks), then one K2 launch reads every row's keys through its
    table, in place, up to its length ``lengths`` (B,) int32, with the
    queries' ends aligned to position ``length - 1``.  A row of length 0
    (not decoding) reads nothing and gets a zero output: garbage-block
    positions never enter an attention.  Every index stays on the device."""
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
        out = ops.paged_attention(q.permute(0, 2, 1, 3).contiguous(), ck, cv,
                                  block_tables, lengths, causal=True,
                                  window=cfg.window).permute(0, 2, 1, 3)
    return proj(out.reshape(B, Sq, nh * hd), p["wo"])


# ---------------------------------------------------------------------------
# SSD (Mamba-2) block
# ---------------------------------------------------------------------------

def ssm_decays(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Per-token decay a_t in (0, 1): sigmoid(x·wa + bias), in f32 from the
    f32 ``wa`` whatever the compute type, as the JAX layer computes it."""
    return torch.sigmoid(proj(x.float(), p["wa"]) + p["a_bias"])


def ssm_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              state: Optional[torch.Tensor] = None,
              out_state: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              state_rows: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD block over x (B, S, d) from ``state`` (B, heads, state, hd) f32
    (zero when None); returns (out (B, S, d), final state), the state
    written into ``out_state`` when given (``state`` itself updates in
    place), rows that ``mask`` (B,) leaves out keeping theirs; with
    ``state_rows`` (B,) int32 row b reads and writes state row
    ``state_rows[b]`` of states of any row count.  B and C are projected
    once and shared across heads (ngroups = 1); the scan, prefill chunk or
    decode step alike, is one K3 call over all rows."""
    s = cfg.ssm
    B, S, _ = x.shape
    xi = proj(x, p["wx"]).reshape(B, S, s.heads, s.head_dim)
    b = proj(x, p["wb"])                                    # (B, S, state)
    c = proj(x, p["wc"])
    y, new_state = ops.ssd_scan(xi, ssm_decays(p, x), b, c, state,
                                out_state=out_state, mask=mask,
                                state_rows=state_rows)
    return proj(y.reshape(B, S, s.heads * s.head_dim), p["wo"]), new_state


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
