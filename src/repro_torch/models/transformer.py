"""Model assembly (the port of ``models/transformer.py``).

Serves the ``attn_mlp`` (dense GQA), ``attn_moe`` (GQA + mixture-of-experts
FFN, :mod:`.moe`), ``ssm`` (attention-free Mamba-2 SSD) and ``hybrid``
(parallel attention + SSD heads) blocks; the encoder-decoder is a later
slice.  Parameters are a dict ``{"embed": {"tok",
"out"}, "layers": [per-layer dicts], "ln_f": {"scale"}}``; the JAX package
stacks layers on a leading axis and scans them, the port keeps a list and
loops.  Weights (>= 2-D) are held in the compute dtype, norm scales and
biases in f32: the JAX forward casts every weight to ``x.dtype`` before use,
so the numbers are the same and a bf16 model takes half the memory.  The
one exception is the SSM decay projection ``wa``, which the JAX layer runs
in f32 from f32 weights whatever the compute type: it stays f32.

The paged serving functions update the KV pool and the per-slot SSM state
**in place** (the JAX ones return a new cache); they still return it, so
callers read the same.  The SSM state is updated in place by the K3 launch
itself: each layer hands its cache slice in as the scan's state and its
output state, so no step allocates or scatters a state.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, torch_dtype
from . import layers as L
from .config import ModelConfig
from .moe import check_moe, moe_block

Params = Dict[str, Any]


def check_block(cfg: ModelConfig) -> None:
    """Raise for a config whose block the port does not serve yet."""
    if cfg.block not in ("attn_mlp", "attn_moe", "ssm", "hybrid") \
            or cfg.encoder is not None:
        raise NotImplementedError(
            f"block {cfg.block!r} (config {cfg.name}) is not ported yet: "
            "the port serves attn_mlp, attn_moe, ssm and hybrid decoders")
    if cfg.block == "attn_moe":
        check_moe(cfg)


def has_attn(cfg: ModelConfig) -> bool:
    return cfg.block in ("attn_mlp", "attn_moe", "hybrid")


def has_ssm(cfg: ModelConfig) -> bool:
    return cfg.block in ("ssm", "hybrid")


def has_mlp(cfg: ModelConfig) -> bool:
    return cfg.block in ("attn_mlp", "hybrid") or (
        cfg.block == "ssm" and cfg.d_ff > 0)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: DeviceLike = None) -> Params:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (the
    card unless the caller passes ``"cpu"``): normal / sqrt(fan_in) for
    matrices (0.1 / sqrt(fan_in) for the SSM decay projection; an expert
    stack (E, fan_in, fan_out) by its own fan_in), 0.02·normal for the
    token table, ones for norm scales, zeros for q/k/v biases, 2.0 for the
    decay bias — the JAX package's distributions, not its numbers."""
    check_block(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    wdt = _dtype(cfg)

    def mat(*shape, scale=None, dtype=wdt):
        w = torch.randn(shape, generator=g, device=dev, dtype=dtype)
        return w.mul_(scale if scale is not None
                      else 1.0 / math.sqrt(max(1, shape[0])))

    def norm():
        return {"scale": torch.ones(cfg.d_model, dtype=torch.float32,
                                    device=dev)}

    d, f, nh, nk, hd = cfg.d_model, cfg.d_ff, cfg.heads, cfg.kv_heads, cfg.hd
    layers = []
    for _ in range(cfg.layers):
        lp: Params = {}
        if has_attn(cfg):
            attn = {"wq": mat(d, nh * hd), "wk": mat(d, nk * hd),
                    "wv": mat(d, nk * hd), "wo": mat(nh * hd, d)}
            if cfg.qkv_bias:
                for name, n in (("bq", nh * hd), ("bk", nk * hd),
                                ("bv", nk * hd)):
                    attn[name] = torch.zeros(n, dtype=torch.float32,
                                             device=dev)
            lp["ln1"], lp["attn"] = norm(), attn
        if has_ssm(cfg):
            s = cfg.ssm
            di = s.heads * s.head_dim
            lp["lns"] = norm()
            lp["ssm"] = {
                "wx": mat(d, di), "wb": mat(d, s.state), "wc": mat(d, s.state),
                "wa": mat(d, s.heads, scale=0.1 / math.sqrt(d),
                          dtype=torch.float32),
                "wo": mat(di, d),
                "a_bias": torch.full((s.heads,), 2.0, dtype=torch.float32,
                                     device=dev)}
        if has_mlp(cfg):
            lp["ln2"] = norm()
            lp["mlp"] = {"wi": mat(d, f), "wg": mat(d, f), "wo": mat(f, d)}
        if cfg.block == "attn_moe":
            E, fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
            lp["ln2"] = norm()
            lp["moe"] = {"router": mat(d, E),
                         "wi": mat(E, d, fe, scale=1 / math.sqrt(d)),
                         "wg": mat(E, d, fe, scale=1 / math.sqrt(d)),
                         "wo": mat(E, fe, d, scale=1 / math.sqrt(fe))}
        layers.append(lp)
    return {"embed": {"tok": mat(cfg.vocab, d, scale=0.02),
                      "out": mat(d, cfg.vocab)},
            "layers": layers, "ln_f": norm()}


def _device(params: Params) -> torch.device:
    return params["embed"]["tok"].device


def _block(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
           ssm_state: Optional[torch.Tensor] = None,
           ssm_mask: Optional[torch.Tensor] = None,
           ssm_rows: Optional[torch.Tensor] = None, **attn_kw
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block: (x, the MoE layer's aux loss or None).  The SSD core's
    final state is written into ``ssm_state`` itself (none is kept when it
    is None), rows that ``ssm_mask`` leaves out keeping theirs, row b at
    ``ssm_rows[b]`` when given.  The hybrid block runs attention and SSD in
    parallel on separately normed inputs and adds both to the residual,
    then the MLP or the MoE FFN, as the JAX ``block_apply`` does.  The MoE
    FFN routes every row of x, rows not decoding included, as the JAX
    decode step does: capacity is per routing call."""
    h = x
    if has_attn(cfg):
        h = h + L.attention(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                            cfg, **attn_kw)
    if has_ssm(cfg):
        ssd, _ = L.ssm_block(
            lp["ssm"], L.rmsnorm(lp["lns"], x, cfg.norm_eps), cfg,
            state=ssm_state, out_state=ssm_state, mask=ssm_mask,
            state_rows=ssm_rows)
        h = h + ssd
    x = h
    aux = None
    if "moe" in lp:
        y, aux = moe_block(lp["moe"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps),
                           cfg)
        x = x + y
    elif "mlp" in lp:
        x = x + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x, aux


def _as(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def _long(x, dev: torch.device) -> torch.Tensor:
    return _as(x, dev, torch.long)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, tokens, *,
            patch_embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward: tokens (B, S) -> (logits (B, S, V),
    the MoE layers' summed aux loss, f32; 0 without MoE).  ``patch_embeds``
    (B', P, d), chameleon's precomputed VQ patch embeddings, replace the
    token embeddings of rows :B' at positions :P (early fusion)."""
    check_block(cfg)
    dev = _device(params)
    tokens = _long(tokens, dev)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, _dtype(cfg))
    if patch_embeds is not None:
        pe = _as(patch_embeds, dev, x.dtype)
        x[:pe.shape[0], :pe.shape[1]] = pe
    positions = torch.arange(S, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for lp in params["layers"]:
        x, aux_l = _block(lp, x, cfg, positions=positions)
        if aux_l is not None:
            aux = aux + aux_l
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x), aux


# ---------------------------------------------------------------------------
# Paged (block-pool) serving path
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_blocks: int, page_size: int,
                     batch: int, dtype: torch.dtype = torch.bfloat16, *,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Decode cache of the paged engine.  Attention configs get the block
    pool {"k", "v"} of shape (layers, num_blocks, page_size, kv_heads, hd),
    bf16 by default as in the JAX package, block 0 the garbage block; SSM
    configs get the per-slot recurrent state "ssm" (layers, batch, heads,
    state, hd) in f32.  An SSM-only config holds no k/v pool."""
    check_block(cfg)
    dev = resolve_device(device)
    c: Dict[str, torch.Tensor] = {}
    if has_attn(cfg):
        shape = (cfg.layers, num_blocks, page_size, cfg.kv_heads, cfg.hd)
        c["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        c["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if has_ssm(cfg):
        s = cfg.ssm
        c["ssm"] = torch.zeros((cfg.layers, batch, s.heads, s.state,
                                s.head_dim), dtype=torch.float32, device=dev)
    return c


def paged_copy_block(cache: Dict[str, torch.Tensor], src: int,
                     dst: int) -> Dict[str, torch.Tensor]:
    """Copy physical block ``src`` into ``dst`` in every layer (in place);
    the per-slot SSM state is not paged and does not move.  The engine's
    copy-on-write for a shared prefix block: on the card two eager
    launches (one for K, one for V, across every layer), enqueued on the
    stream with no host sync, before the tick's captured steps; the JAX
    counterpart is plain ``jnp`` too, not a Pallas kernel."""
    for key in ("k", "v"):
        if key in cache:
            cache[key][:, int(dst)] = cache[key][:, int(src)]
    return cache


def _layer_kv(cache: Dict[str, torch.Tensor], i: int
              ) -> Optional[Dict[str, torch.Tensor]]:
    return {"k": cache["k"][i], "v": cache["v"][i]} if "k" in cache else None


def paged_prefill_step(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
                       start: torch.Tensor, block_table: torch.Tensor,
                       slot: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One chunk of a paged prefill on device inputs only: ``tokens`` (1,
    C) int at logical offset ``start`` (1,) int32 of the sequence whose
    block table is ``block_table`` (1, nblk) int32 and whose SSM state is
    row ``slot`` (1,) int32 of the cache.  The chunk's positions are start
    + arange(C), its K/V go in at ``start`` and it attends over keys 0 ..
    start + C - 1 (its length), so end alignment reproduces the causal mask
    of the JAX layer; each layer hands its whole per-slot SSM state to K3
    with ``slot`` as the one state row, which resumes from it and updates
    it in place, so chunks thread the recurrence exactly.  The step reads
    its inputs on the device and does no host work and no host-device
    copy, so a CUDA graph can capture it once a chunk length and replay it
    on new contents of the same tensors.  Returns (last-token logits (1,
    V), cache)."""
    C = tokens.shape[1]
    idx = start.long()
    positions = idx + torch.arange(C, device=tokens.device)
    lens = (start + C).to(torch.int32)
    x = L.embed(params["embed"], tokens.long(), _dtype(cfg))
    ssm = cache.get("ssm")
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(
            lp, x, cfg, ssm_state=ssm[i] if ssm is not None else None,
            ssm_rows=slot, positions=positions, cache=_layer_kv(cache, i),
            cache_index=idx, block_tables=block_table, lengths=lens)
    x = L.rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache


def paged_prefill_chunk(params: Params, cfg: ModelConfig, tokens,
                        cache: Dict[str, torch.Tensor], cache_index: int,
                        block_table, slot: int = 0
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`paged_prefill_step` from host values, as the JAX function
    takes them: ``tokens`` (1, C), the offset ``cache_index`` and the
    ``slot`` as ints, the ``block_table`` (1, nblk); each is uploaded to the
    params' device first."""
    dev = _device(params)
    one = functools.partial(torch.full, (1,), dtype=torch.int32, device=dev)
    return paged_prefill_step(params, cfg, _long(tokens, dev), cache,
                              one(int(cache_index)),
                              _as(block_table, dev, torch.int32),
                              one(int(slot)))


def paged_decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: Dict[str, torch.Tensor],
                      cache_index: torch.Tensor, block_tables: torch.Tensor,
                      *, active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over the paged pool: ``tokens`` (B, 1) int, per-row
    ``cache_index`` (B,) int, ``block_tables`` (B, nblk) int32 and
    ``active`` (B,) bool (None: every row decodes), all tensors on the
    params' device.  The step reads them there and does no host work and no
    host-device copy, so a CUDA graph can capture it once and replay it on
    new contents of the same tensors.  Rows not decoding get length 0: they
    write the garbage block, as in the JAX step, read nothing and keep
    their SSM state (the JAX ``ssm_mask``: dead slots, and slots whose
    chunked prefill is still in flight); their logits are meaningless and
    ignored.  Each layer makes one K2 launch (every row through its table)
    and one K3 launch over all rows, which updates the layer's
    ``cache["ssm"]`` slice in place for the active rows."""
    B = tokens.shape[0]
    idx = cache_index.long()
    lens = idx + 1 if active is None else torch.where(active, idx + 1, 0)
    lens = lens.to(torch.int32)
    x = L.embed(params["embed"], tokens.long(), _dtype(cfg))
    positions = idx[:, None]
    ssm = cache.get("ssm")
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(
            lp, x, cfg, ssm_state=ssm[i, :B] if ssm is not None else None,
            ssm_mask=active, positions=positions, cache=_layer_kv(cache, i),
            cache_index=idx, block_tables=block_tables, lengths=lens)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0], cache
