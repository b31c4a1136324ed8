"""Functional model layers on tensors (the port of ``models/layers.py``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts (``wq`` is [d_model, heads·hd], ...), so a JAX pytree converts leaf
for leaf (:mod:`repro_torch.convert`).  Every projection goes through
``ops.matmul`` (K1), every attention core through K2's paged entry
``ops.paged_attention`` (over the paged pool, or over a batch's contiguous
K/V read as a pool of one block a row: one launch a layer), and every SSD
core through ``ops.ssd_scan`` (K3): the design the JAX
layers state and their warm set traces, although their forward is einsum
on every backend (ROADMAP F3).  The port is held against that einsum math.

The layers of the ported blocks (``attn_mlp``, ``attn_moe``, ``ssm``,
``hybrid`` and whisper's encoder and decoder): RMSNorm, RoPE, attention
(self- and cross-attention; no cache, the non-paged cache with its ring,
and the paged pool), the Mamba-2 SSD block, the SwiGLU MLP, embed and
unembed.

Tensor parallelism over the current mesh's ``model`` axis (the training
forward of a mesh step) is read off each leaf: a weight whose column dim
(``q_proj``, ``kv_proj``, ``ff``, ``vocab``) is a ``1 / model`` part of
the config's is the rank's columns, as its spec shards it.  Attention's
``wq``, ``wk``, ``wv`` (and qwen's biases) and the MLP's ``wi``, ``wg``
are then column-parallel and ``wo`` row-parallel, with one all-reduce of
the output over ``model``; ``embed`` looks up the rows the rank holds and
all-reduces, ``unembed`` gives the rank's vocab columns.  The rank
computes the heads its ``wo`` rows need (:func:`tp_heads`); where its
columns do not hold whole heads and their KV heads, the projections'
outputs are gathered over ``model`` first.  Cross-attention projects its
K/V from the encoder output the same way.  The SSD block
(:func:`ssm_block`) is column-parallel in ``wx``, row-parallel in ``wo``;
``wb`` and ``wc`` hold the rank's columns of the state dim, whose
projections are gathered whole (B and C are shared across heads); ``wa``
and ``a_bias`` hold the rank's heads where the head count divides, and
are whole otherwise (:func:`ssm_tp_plan`).  The collectives are
:mod:`repro_torch.distributed.comm`'s Megatron pair, so every rank along
``model`` backpropagates the one loss they compute together.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import sharding as dist
from ..distributed.comm import copy_to, gather, reduce_from
from ..kernels import ops
from ..kernels.autograd import AttentionFn, MatmulFn, SsdScanFn
from .config import ModelConfig

Params = Dict[str, Any]


def recording(*ts: torch.Tensor) -> bool:
    """Whether autograd records a call on ``ts``: the kernels then run
    through their autograd functions (:mod:`repro_torch.kernels.autograd`),
    and otherwise, on every serve path, through ``ops`` as they always
    have."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] through K1; the result takes x's type, as the
    JAX einsum over ``w.astype(x.dtype)`` does."""
    lead = x.shape[:-1]
    a, b = x.reshape(-1, x.shape[-1]).contiguous(), w.to(x.dtype)
    y = MatmulFn.apply(a, b) if recording(a, b) else ops.matmul(a, b)
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
# Attention (GQA + causal/window masks; no cache, contiguous cache or paged
# KV pool; self- or cross-attention)
# ---------------------------------------------------------------------------

def _readable(kv: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K/V in a type K2 reads under queries of ``dtype``: their own, or a
    bf16 pool, which f32 queries upcast as they load it (the exact cast
    ``astype(x.dtype)`` of the JAX layer); anything else is cast."""
    return kv if kv.dtype in (dtype, torch.bfloat16) else kv.to(dtype)


def _rows_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lens: torch.Tensor, *, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """q (B, Sq, nh, hd) of row b over the first ``lens[b]`` keys of k, v
    (B, P, nk, hd), queries ends-aligned at ``lens[b] - 1``: the rows' K/V
    are a pool of B blocks of page P, row b's table ``[[b]]``, read in place
    by one launch of K2's paged entry (the lengths stay on the device).  K2
    takes at most P queries a launch: a longer non-causal, unwindowed
    attention (cross-attention over a short context) runs its queries in
    runs of at most P, which are independent rows of the softmax.  While
    autograd records, each launch goes through ``AttentionFn`` (K2 forward,
    K2b backward) and ``torch.cat`` joins the runs."""
    B, Sq = q.shape[:2]
    P = k.shape[1]
    tables = torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
    qh = q.permute(0, 2, 1, 3).contiguous()
    grad = recording(q, k, v)

    def core(qr, causal, window):
        if grad:
            return AttentionFn.apply(qr, k, v, None, lens, causal, window)
        return ops.paged_attention(qr, k, v, tables, lens, causal=causal,
                                   window=window)

    if Sq <= P:
        out = core(qh, causal, window)
    elif causal or window is not None:
        raise ValueError(f"{Sq} queries over {P} keys: only a non-causal, "
                         "unwindowed attention takes more queries than keys")
    else:
        out = torch.cat([core(qh[:, :, s:s + P].contiguous(), False, None)
                         for s in range(0, Sq, P)], dim=2)
    return out.permute(0, 2, 1, 3)


def _full(B: int, n, device: torch.device) -> torch.Tensor:
    return torch.full((B,), n, dtype=torch.int32, device=device)


def _cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache: Dict[str, torch.Tensor],
                     cache_index: torch.Tensor, cfg: ModelConfig, *,
                     causal: bool) -> torch.Tensor:
    """Self-attention over the non-paged cache {"k","v"} (B, W, nk, hd),
    written in place at positions ``cache_index + i`` (``cache_index`` a 0-d
    or (B,) integer tensor on the device).  A windowed config whose cache
    is no longer than its window keeps a ring: token t in slot t % W (a
    prompt of at least W tokens writes only its last W).  A prompt (more
    than one query) on the ring attends within itself, over its unrounded
    K/V, as the JAX layer does; one query reads the first min(idx + 1, W)
    slots unmasked: every written slot holds a token inside the window, so
    this is the JAX layer's masked softmax over the ring, summed in slot
    order.  Any other cache is read up to ``cache_index + Sq`` with the
    causal (and window) mask, queries ends-aligned, in the cache's type."""
    ck, cv = cache["k"], cache["v"]
    B, Sq = q.shape[:2]
    W = ck.shape[1]
    dev = q.device
    idx = cache_index.long().reshape(-1).expand(B)
    rows = torch.arange(B, device=dev)[:, None]
    steps = torch.arange(Sq, device=dev)[None]
    if cfg.window is not None and W <= cfg.window:
        if Sq >= W:
            kw_, vw_ = k[:, -W:], v[:, -W:]
            slots = (idx[:, None] + Sq - W + steps[:, :W]) % W
        else:
            kw_, vw_ = k, v
            slots = (idx[:, None] + steps) % W
        ck[rows, slots] = kw_.to(ck.dtype)
        cv[rows, slots] = vw_.to(cv.dtype)
        if Sq > 1:
            return _rows_attention(q, k, v, _full(B, Sq, dev), causal=causal,
                                   window=cfg.window)
        lens = torch.clamp(idx + 1, max=W).to(torch.int32)
        return _rows_attention(q, _readable(ck, q.dtype),
                               _readable(cv, q.dtype), lens, causal=False,
                               window=None)
    slots = idx[:, None] + steps
    ck[rows, slots] = k.to(ck.dtype)
    cv[rows, slots] = v.to(cv.dtype)
    return _rows_attention(q, _readable(ck, q.dtype), _readable(cv, q.dtype),
                           (idx + Sq).to(torch.int32), causal=causal,
                           window=cfg.window)


def model_split(w: torch.Tensor, dim: int, whole: int) -> int:
    """How many ranks of the current mesh's ``model`` axis share ``w``'s
    ``dim``, whose whole size is ``whole``: 1 where the leaf is whole;
    raises where its part is not ``1 / model`` of it."""
    n = w.shape[dim]
    if n == whole:
        return 1
    mesh = dist.current_mesh()
    t = mesh.shape.get("model", 1) if mesh is not None else 1
    if t == 1 or n * t != whole:
        raise ValueError(f"a leaf of {n} columns of {whole} on a mesh of "
                         f"model {t}: not its spec's part")
    return t


def tp_heads(cfg: ModelConfig, t: int, j: int) -> Dict[str, int]:
    """The attention heads rank ``j`` of ``t`` along ``model`` computes:
    its ``wo`` rows are the ``q_proj`` columns [c0, c1), which the query
    heads [h0, h1) cover, over the KV heads [k0, k1) they read.  ``group``
    is the query heads a KV head in K2's launch: their GQA group when the
    rank's heads map onto its KV heads as K2 maps them (head i to KV head
    i // group), else 1, the KV heads then repeated for each query head."""
    nq = cfg.heads * cfg.hd // t
    c0, c1 = j * nq, (j + 1) * nq
    h0, h1 = c0 // cfg.hd, -(-c1 // cfg.hd)
    g = cfg.heads // cfg.kv_heads
    k0, k1 = h0 // g, (h1 - 1) // g + 1
    h, hk = h1 - h0, k1 - k0
    group = h // hk if h % hk == 0 and all(
        (h0 + i) // g - k0 == i // (h // hk) for i in range(h)) else 1
    return {"c0": c0, "c1": c1, "h0": h0, "h1": h1, "k0": k0, "k1": k1,
            "group": group}


def _tp_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, t: int,
                  *, positions: torch.Tensor, causal: bool,
                  context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`attention` without a cache over ``model`` ranks: each
    column-parallel projection of ``copy_to(x)`` (K/V of
    ``copy_to(context)`` for cross-attention) gives the rank's columns (a
    weight whose ``kv_proj`` does not divide is whole, and enters through
    ``copy_to`` too: the rank reads only some of its heads); the columns of
    the heads :func:`tp_heads` names come from the rank's own where it
    holds them, else from the projection's output gathered over
    ``model``; the output columns of its ``wo`` rows go through ``wo`` and
    one all-reduce (``reduce_from``).  Cross-attention puts RoPE on
    neither q nor k and masks nothing."""
    B, Sq, _ = x.shape
    hd = cfg.hd
    mesh = dist.current_mesh()
    group = mesh.group(("model",))
    plan = tp_heads(cfg, t, mesh.coords()["model"])
    xin = copy_to(x, group)
    src = xin if context is None else copy_to(context, group)
    Sk = src.shape[1]

    def column(wname: str, bname: str, whole: int, lo: int, hi: int,
               inp: torch.Tensor) -> torch.Tensor:
        w, b = p[wname], p.get(bname) if cfg.qkv_bias else None
        if model_split(w, 1, whole) == 1:
            w = copy_to(w, group)
            b = copy_to(b, group) if b is not None else None
            c0 = 0
        else:
            c0 = mesh.coords()["model"] * w.shape[1]
        y = proj(inp, w)
        if b is not None:
            y = y + b.to(x.dtype)
        if not (c0 <= lo and hi <= c0 + y.shape[-1]):
            y, c0 = gather(y, -1, group), 0
        return y[..., lo - c0:hi - c0]

    h0, h1, k0, k1 = plan["h0"], plan["h1"], plan["k0"], plan["k1"]
    nq, nk = cfg.heads * hd, cfg.kv_heads * hd
    q = column("wq", "bq", nq, h0 * hd, h1 * hd, xin).reshape(
        B, Sq, h1 - h0, hd)
    k = column("wk", "bk", nk, k0 * hd, k1 * hd, src).reshape(
        B, Sk, k1 - k0, hd)
    v = column("wv", "bv", nk, k0 * hd, k1 * hd, src).reshape(
        B, Sk, k1 - k0, hd)
    if context is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if plan["group"] == 1 and k1 - k0 != h1 - h0:
        g = cfg.heads // cfg.kv_heads
        idx = torch.tensor([(h0 + i) // g - k0 for i in range(h1 - h0)],
                           device=x.device)
        k, v = k[:, :, idx], v[:, :, idx]
    out = _rows_attention(q, k.contiguous(), v.contiguous(),
                          _full(B, Sk, x.device), causal=causal,
                          window=cfg.window if context is None else None)
    lo = plan["c0"] - h0 * hd
    out = out.reshape(B, Sq, (h1 - h0) * hd)[..., lo:lo + plan["c1"]
                                             - plan["c0"]]
    return reduce_from(proj(out, p["wo"]), group)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_index: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None,
              lengths: Optional[torch.Tensor] = None,
              causal: bool = True,
              context: Optional[torch.Tensor] = None,
              precomputed_kv: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
              return_kv: bool = False):
    """Self-attention over x (B, Sq, d), or cross-attention when
    ``context`` (B, Sk, d) or ``precomputed_kv`` (k, v) (B, Sk, nk, hd) is
    given; returns the output (B, Sq, d), or (output, (k, v)) with the
    projected, unrounded K/V of ``context`` under ``return_kv``.

    Cross-attention projects K/V from ``context`` (or reads them as given,
    whisper's cross cache, cast to x's type), puts RoPE on neither q nor k,
    and is never causal or windowed.  Self-attention puts RoPE on q and k at
    ``positions`` and masks causally (when ``causal``) and by the config's
    window.  Without ``cache`` every row attends over its own Sq tokens,
    one K2 launch for all rows.  A non-paged ``cache`` {"k","v"} (B, W, nk,
    hd) is written in place and read as :func:`_cache_attention` says.
    With a paged ``cache`` — block pools {"k","v"} of shape (num_blocks,
    page_size, nk, hd), written **in place** — this call's K/V are
    scattered into the rows' physical blocks at logical positions
    ``cache_index + i`` (``block_tables`` (B, nblk) int32 maps logical to
    physical blocks), then one K2 launch reads every row's keys through its
    table, in place, up to its length ``lengths`` (B,) int32, with the
    queries' ends aligned to position ``length - 1``.  A row of length 0
    (not decoding) reads nothing and gets a zero output: garbage-block
    positions never enter an attention.  Every index stays on the device."""
    B, Sq, d = x.shape
    nh, nk, hd = cfg.heads, cfg.kv_heads, cfg.hd
    t = model_split(p["wq"], 1, nh * hd)
    if t > 1:
        if cache is not None or precomputed_kv is not None or return_kv:
            raise NotImplementedError(
                "tensor parallelism covers self- and cross-attention "
                "without a cache (the training forward)")
        return _tp_attention(p, x, cfg, t, positions=positions,
                             causal=causal, context=context)
    q = proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, Sq, nh, hd)
    cross = context is not None or precomputed_kv is not None
    if precomputed_kv is not None:
        k, v = precomputed_kv
    else:
        src = x if context is None else context
        k = proj(src, p["wk"])
        v = proj(src, p["wv"])
        if cfg.qkv_bias:
            k = k + p["bk"].to(x.dtype)
            v = v + p["bv"].to(x.dtype)
        k = k.reshape(B, -1, nk, hd)
        v = v.reshape(B, -1, nk, hd)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cross:
        out = _rows_attention(q, _readable(k, x.dtype),
                              _readable(v, x.dtype),
                              _full(B, k.shape[1], x.device), causal=False,
                              window=None)
    elif cache is None:
        out = _rows_attention(q, k, v, _full(B, Sq, x.device), causal=causal,
                              window=cfg.window)
    elif block_tables is None:
        out = _cache_attention(q, k, v, cache, cache_index, cfg,
                               causal=causal)
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
                                  block_tables, lengths, causal=causal,
                                  window=cfg.window).permute(0, 2, 1, 3)
    y = proj(out.reshape(B, Sq, nh * hd), p["wo"])
    return (y, (k, v)) if return_kv else y


# ---------------------------------------------------------------------------
# SSD (Mamba-2) block
# ---------------------------------------------------------------------------

def ssm_decays(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Per-token decay a_t in (0, 1): sigmoid(x·wa + bias), in f32 from the
    f32 ``wa`` whatever the compute type, as the JAX layer computes it."""
    return torch.sigmoid(proj(x.float(), p["wa"]) + p["a_bias"])


def ssm_tp_plan(cfg: ModelConfig, t: int, j: int) -> Optional[Dict[str, int]]:
    """The SSD heads rank ``j`` of ``t`` along ``model`` computes, or None
    where the block's leaves are all whole (none of d_inner, the state
    and the head count divides by t: every rank runs the block as one
    process does).  Its ``wo`` rows are the d_inner columns [c0, c1)
    (``j·d_inner // t`` on), which the heads [h0, h1) cover; a head cut
    by a rank boundary is scanned whole by both ranks, each keeping its
    columns of the output."""
    s = cfg.ssm
    di = s.heads * s.head_dim
    if t == 1 or all(n % t for n in (di, s.state, s.heads)):
        return None
    c0, c1 = j * di // t, (j + 1) * di // t
    return {"c0": c0, "c1": c1, "h0": c0 // s.head_dim,
            "h1": -(-c1 // s.head_dim)}


def _cols(y: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) of ``y``'s last dim, contiguous."""
    return y if (lo, hi) == (0, y.shape[-1]) else y[..., lo:hi].contiguous()


def _tp_ssm(p: Params, x: torch.Tensor, cfg: ModelConfig,
            plan: Dict[str, int]) -> torch.Tensor:
    """:func:`ssm_block` without a state over ``model`` ranks, on the
    heads of :func:`ssm_tp_plan`'s ``plan``: x's columns of those heads
    from the rank's ``wx`` columns (gathered over ``model`` where a head
    is cut), all N columns of b and c (the rank's gathered), the heads'
    decays (from the rank's ``wa`` heads, or from the whole ``wa``),
    one K3 call over the heads, and the output columns of the rank's
    ``wo`` rows through ``wo`` and one all-reduce.  A whole leaf enters
    through ``copy_to``: the rank reads only part of what it gives."""
    s = cfg.ssm
    B, S, _ = x.shape
    hd, di = s.head_dim, s.heads * s.head_dim
    mesh = dist.current_mesh()
    group = mesh.group(("model",))
    c0, c1, h0, h1 = plan["c0"], plan["c1"], plan["h0"], plan["h1"]
    xin = copy_to(x, group)

    def split(name: str, dim: int, whole: int) -> bool:
        return model_split(p[name], dim, whole) > 1

    if split("wx", 1, di):
        xi, at = proj(xin, p["wx"]), c0
        if (h0 * hd, h1 * hd) != (c0, c1):
            xi, at = gather(xi, -1, group), 0
    else:
        xi, at = proj(xin, copy_to(p["wx"], group)), 0
    xi = _cols(xi, h0 * hd - at, h1 * hd - at).reshape(B, S, h1 - h0, hd)

    def shared(name: str) -> torch.Tensor:
        if split(name, 1, s.state):
            return gather(proj(xin, p[name]), -1, group)
        return proj(xin, copy_to(p[name], group))

    b, c = shared("wb"), shared("wc")
    if split("wa", 1, s.heads):
        a = torch.sigmoid(proj(xin.float(), p["wa"]) + p["a_bias"])
    else:
        a = torch.sigmoid(proj(xin.float(), copy_to(p["wa"], group))
                          + copy_to(p["a_bias"], group))
        a = _cols(a, h0, h1)
    if recording(xi, a, b, c):
        y, _ = SsdScanFn.apply(xi, a, b, c, None, None, None, None)
    else:
        y, _ = ops.ssd_scan(xi, a, b, c, None)
    y = _cols(y.reshape(B, S, (h1 - h0) * hd), c0 - h0 * hd, c1 - h0 * hd)
    wo = p["wo"] if split("wo", 0, di) else copy_to(p["wo"], group)[c0:c1]
    return reduce_from(proj(y, wo), group)


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
    decode step alike, is one K3 call over all rows.  While autograd
    records, the scan goes through ``SsdScanFn`` (K3 forward, K3b
    backward), which refuses the serve-only ``out_state``, ``mask`` and
    ``state_rows``.  Where a leaf holds the rank's part along the mesh's
    ``model`` axis, tensor-parallel (:func:`_tp_ssm`; the training
    forward: no state, and the final state is None)."""
    s = cfg.ssm
    B, S, _ = x.shape
    mesh = dist.current_mesh()
    t = mesh.shape.get("model", 1) if mesh is not None else 1
    split = t > 1 and any(
        model_split(p[name], 1, whole) > 1 for name, whole in (
            ("wx", s.heads * s.head_dim), ("wb", s.state), ("wa", s.heads)))
    if split:
        if any(v is not None for v in (state, out_state, mask, state_rows)):
            raise NotImplementedError(
                "tensor parallelism covers the SSD block without a state "
                "(the training forward)")
        plan = ssm_tp_plan(cfg, t, mesh.coords()["model"])
        return _tp_ssm(p, x, cfg, plan), None
    xi = proj(x, p["wx"]).reshape(B, S, s.heads, s.head_dim)
    b = proj(x, p["wb"])                                    # (B, S, state)
    c = proj(x, p["wc"])
    a = ssm_decays(p, x)
    if recording(xi, a, b, c, *([state] if state is not None else [])):
        y, new_state = SsdScanFn.apply(xi, a, b, c, state, out_state, mask,
                                       state_rows)
    else:
        y, new_state = ops.ssd_scan(xi, a, b, c, state, out_state=out_state,
                                    mask=mask, state_rows=state_rows)
    return proj(y.reshape(B, S, s.heads * s.head_dim), p["wo"]), new_state


# ---------------------------------------------------------------------------
# SwiGLU MLP, embedding
# ---------------------------------------------------------------------------

def mlp(p: Params, x: torch.Tensor, d_ff: int) -> torch.Tensor:
    """SwiGLU; where ``wi`` holds the rank's columns of ``d_ff`` (the
    config's), ``wi`` and ``wg`` column-parallel and ``wo`` row-parallel
    over the mesh's ``model`` axis."""
    group = None
    if model_split(p["wi"], 1, d_ff) > 1:
        group = dist.current_mesh().group(("model",))
        x = copy_to(x, group)
    h = proj(x, p["wi"])
    g = proj(x, p["wg"])
    y = proj(F.silu(g) * h, p["wo"])
    return y if group is None else reduce_from(y, group)


def embed(p: Params, tokens: torch.Tensor, dtype: torch.dtype,
          vocab: int) -> torch.Tensor:
    """Token rows; where ``tok`` holds the rank's rows of ``vocab`` (the
    config's), vocab-parallel: the rank looks up the tokens it holds,
    zeroes the others, and the ranks along ``model`` all-reduce."""
    tok = p["tok"]
    if model_split(tok, 0, vocab) == 1:
        return tok[tokens].to(dtype)
    mesh = dist.current_mesh()
    local = tokens - mesh.coords()["model"] * tok.shape[0]
    held = (local >= 0) & (local < tok.shape[0])
    rows = tok[torch.where(held, local, 0)] * held[..., None]
    return reduce_from(rows.to(dtype), mesh.group(("model",)))


def unembed(p: Params, x: torch.Tensor, vocab: int) -> torch.Tensor:
    """Logits; where ``out`` holds the rank's columns of ``vocab`` (the
    config's), the rank's vocab columns (the loss is then vocab-parallel:
    ``runtime.steps.cross_entropy``)."""
    out = p["out"]
    if model_split(out, 1, vocab) > 1:
        x = copy_to(x, dist.current_mesh().group(("model",)))
    return proj(x, out)
