"""Model assembly (the port of ``models/transformer.py``).

Serves the ``attn_mlp`` (dense GQA), ``attn_moe`` (GQA + mixture-of-experts
FFN, :mod:`.moe`), ``ssm`` (attention-free Mamba-2 SSD) and ``hybrid``
(parallel attention + SSD heads) blocks, and the whisper encoder-decoder
(``encode`` over precomputed frame embeddings, cross-attention in every
decoder block).  Parameters are a dict ``{"embed": {"tok", "out"},
"layers": [per-layer dicts], "ln_f": {"scale"}}``, with ``"enc_layers"``
and ``"enc_ln_f"`` for an encoder; the JAX package stacks layers on a
leading axis and scans them, the port's serve tree keeps a list and loops.
The training state (:func:`init_train_state`) keeps the JAX layout, f32
masters stacked [L, ...], which :func:`forward` reads through per-layer
views (:func:`layer_list`).  The serve tree holds weights (>= 2-D) in the
compute dtype, norm scales and biases in f32: the JAX forward casts every
weight to ``x.dtype`` before use, so the numbers are the same and a bf16
model takes half the memory.  The one exception is the SSM decay
projection ``wa``, which the JAX layer runs in f32 from f32 weights
whatever the compute type: it stays f32.

Two serve paths: the non-paged steps (``init_cache``, ``prefill``,
``decode_step``: one contiguous cache row a sequence, whisper's only way to
serve) and the paged ones the engine runs.  Both update the cache and the
SSM state **in place** (the JAX ones return a new cache); they still
return it, so callers read the same.  The SSM state is updated in place by the K3 launch
itself: each layer hands its cache slice in as the scan's state and its
output state, so no step allocates or scatters a state.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..device import DeviceLike, resolve_device, torch_dtype
from ..optim import tree_leaves
from . import layers as L
from .config import ModelConfig
from .moe import a2a_padded_experts, moe_block

Params = Dict[str, Any]


def check_block(cfg: ModelConfig) -> None:
    """Raise for a config whose block the port does not serve."""
    if cfg.block not in ("attn_mlp", "attn_moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"block {cfg.block!r} (config {cfg.name}) is not ported: the "
            "port serves attn_mlp, attn_moe, ssm and hybrid blocks")


def check_train(cfg: ModelConfig) -> None:
    """Raise for a config the port cannot train (on every device): one it
    does not serve (:func:`check_block`), or a remat policy no config
    uses.  Every block it serves trains: ``attn_mlp``, ``attn_moe`` (with
    the ``moe_a2a`` flag too), ``ssm`` and ``hybrid``."""
    check_block(cfg)
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"remat {cfg.remat!r} (config {cfg.name}) "
                                  "is not ported: 'none' or 'full'")


def check_mesh(cfg: ModelConfig, mesh) -> None:
    """Raise for a config the mesh train step does not cover on ``mesh``:
    the ``moe_a2a`` schedule on a mesh of more than one pod (ROADMAP
    Queue 1 item 4c, part 4).  Every config takes every single-pod mesh,
    under its own flags: the attention, MLP, SSD and cross-attention
    layers tensor-parallel over ``model`` where a leaf holds the rank's
    part (:mod:`.layers`), whisper's encoder too, and the dense MoE layer
    expert-parallel over ``data`` with its experts' ``ff`` over ``model``
    (:mod:`.moe`)."""
    from .moe_a2a import a2a_active
    if a2a_active(cfg, mesh) and mesh.shape.get("pod", 1) > 1:
        raise NotImplementedError(
            f"config {cfg.name} under 'moe_a2a' on a mesh of "
            f"{mesh.shape['pod']} pods: the JAX schedule replicates its "
            "groups over pods, which is ROADMAP Queue 1 item 4c, part 4; a "
            "single-pod mesh, or the dense layer, trains it")


def check_paged(cfg: ModelConfig) -> None:
    """Raise, as the JAX package does, for a config the paged serve path
    does not take: an encoder-decoder."""
    check_block(cfg)
    if cfg.encoder is not None:
        raise ValueError("paged serving does not support encoder-decoder "
                         "configs")


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
    decay bias — the JAX package's distributions, not its numbers.  An
    encoder config also gets cross-attention (``lnx``, ``xattn``) in every
    decoder layer, ``cfg.encoder.layers`` encoder layers and ``enc_ln_f``."""
    check_block(cfg)
    return _init(cfg, seed, resolve_device(device), _dtype(cfg))


def _init(cfg: ModelConfig, seed: int, dev: torch.device,
          wdt: torch.dtype, keep=None) -> Params:
    """:func:`init_model`'s tree with matrices in ``wdt``; on the ``meta``
    device (no generator lives there) the leaves have shapes and types
    only.  ``keep(path, leaf, lead)``, when given, replaces each leaf as
    soon as it is built (``lead``: 1 for a layer's leaf, whose path is its
    stacked leaf's, 0 otherwise), in the generator's order."""
    g = None
    if dev.type != "meta":
        g = torch.Generator(device=dev)
        g.manual_seed(seed)

    def mat(*shape, scale=None, dtype=wdt):
        if g is None:
            return torch.empty(shape, device=dev, dtype=dtype)
        w = torch.randn(shape, generator=g, device=dev, dtype=dtype)
        return w.mul_(scale if scale is not None
                      else 1.0 / math.sqrt(max(1, shape[0])))

    def norm():
        return {"scale": torch.ones(cfg.d_model, dtype=torch.float32,
                                    device=dev)}

    def kept(path, x, lead=1):
        return x if keep is None else keep(path, x, lead)

    d, f, nh, nk, hd = cfg.d_model, cfg.d_ff, cfg.heads, cfg.kv_heads, cfg.hd

    # each dict's values are built in order, so a leaf is kept before the
    # next one is drawn
    def attention(pre):
        attn = {"wq": kept(pre + ("wq",), mat(d, nh * hd)),
                "wk": kept(pre + ("wk",), mat(d, nk * hd)),
                "wv": kept(pre + ("wv",), mat(d, nk * hd)),
                "wo": kept(pre + ("wo",), mat(nh * hd, d))}
        if cfg.qkv_bias:
            for name, n in (("bq", nh * hd), ("bk", nk * hd),
                            ("bv", nk * hd)):
                attn[name] = kept(pre + (name,), torch.zeros(
                    n, dtype=torch.float32, device=dev))
        return attn

    def norm_at(path, lead=1):
        return {"scale": kept(path + ("scale",), norm()["scale"], lead)}

    def layer(key: str, cross: bool) -> Params:
        lp: Params = {}
        if has_attn(cfg):
            lp["ln1"] = norm_at((key, "ln1"))
            lp["attn"] = attention((key, "attn"))
        if has_ssm(cfg):
            s = cfg.ssm
            di = s.heads * s.head_dim
            sp = (key, "ssm")
            lp["lns"] = norm_at((key, "lns"))
            lp["ssm"] = {
                "wx": kept(sp + ("wx",), mat(d, di)),
                "wb": kept(sp + ("wb",), mat(d, s.state)),
                "wc": kept(sp + ("wc",), mat(d, s.state)),
                "wa": kept(sp + ("wa",), mat(d, s.heads,
                                             scale=0.1 / math.sqrt(d),
                                             dtype=torch.float32)),
                "wo": kept(sp + ("wo",), mat(di, d)),
                "a_bias": kept(sp + ("a_bias",), torch.full(
                    (s.heads,), 2.0, dtype=torch.float32, device=dev))}
        if cross:
            lp["lnx"] = norm_at((key, "lnx"))
            lp["xattn"] = attention((key, "xattn"))
        if has_mlp(cfg):
            mp = (key, "mlp")
            lp["ln2"] = norm_at((key, "ln2"))
            lp["mlp"] = {"wi": kept(mp + ("wi",), mat(d, f)),
                         "wg": kept(mp + ("wg",), mat(d, f)),
                         "wo": kept(mp + ("wo",), mat(f, d))}
        if cfg.block == "attn_moe":
            E, fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
            mp = (key, "moe")
            lp["ln2"] = norm_at((key, "ln2"))
            Es = a2a_padded_experts(cfg)
            lp["moe"] = {
                "router": kept(mp + ("router",), mat(d, E)),
                "wi": kept(mp + ("wi",), mat(Es, d, fe,
                                             scale=1 / math.sqrt(d))),
                "wg": kept(mp + ("wg",), mat(Es, d, fe,
                                             scale=1 / math.sqrt(d))),
                "wo": kept(mp + ("wo",), mat(Es, fe, d,
                                             scale=1 / math.sqrt(fe)))}
        return lp

    cross = cfg.encoder is not None
    params = {"embed": {"tok": kept(("embed", "tok"),
                                    mat(cfg.vocab, d, scale=0.02), 0),
                        "out": kept(("embed", "out"), mat(d, cfg.vocab), 0)},
              "layers": [layer("layers", cross) for _ in range(cfg.layers)],
              "ln_f": norm_at(("ln_f",), 0)}
    if cross:
        # encoder blocks share the decoder backbone's dims, without
        # cross-attention
        params["enc_layers"] = [layer("enc_layers", False)
                                for _ in range(cfg.encoder.layers)]
        params["enc_ln_f"] = norm_at(("enc_ln_f",), 0)
    return params


def stack_layers(layers: list) -> Params:
    """Per-layer dicts -> one dict of leaves stacked on a leading [L] axis
    (the JAX package's layout)."""
    return {k: (stack_layers([lp[k] for lp in layers])
                if isinstance(layers[0][k], dict)
                else torch.stack([lp[k] for lp in layers]))
            for k in layers[0]}


def init_train_state(cfg: ModelConfig, *, seed: int = 0,
                     device: DeviceLike = None, keep=None) -> Params:
    """Training parameters from a seed: :func:`init_model`'s distributions
    in the JAX package's training layout, every leaf in ``param_dtype``
    (f32 masters) and ``layers`` / ``enc_layers`` stacked [L, ...], so the
    optimizer, the global norm and checkpoint names match the JAX tree's
    leaf for leaf.  ``device="meta"`` gives shapes only (no allocation).
    Any config has a state; a train step refuses the configs the port does
    not train (:func:`check_train`).  ``keep(path, leaf, lead)`` replaces
    each leaf as it is built, before the next one is drawn (a rank's part:
    ``launch.specs.rank_state``); ``lead`` is 1 for a layer's leaf, 0 for
    the others, and ``path`` the stacked leaf's."""
    check_block(cfg)
    params = _init(cfg, seed, resolve_device(device),
                   torch_dtype(cfg.param_dtype), keep)
    for key in ("layers", "enc_layers"):
        if key in params:
            params[key] = stack_layers(params[key])
    return params


def layer_list(stack, n: int, name: str = "layers") -> list:
    """The per-layer dicts of a serve tree's list, as it is, or views of a
    training tree's stacked leaves (``unbind``: no copy, and their gradients
    land on the stacked leaves as one stack); raises when the depth is not
    ``n``."""
    if isinstance(stack, list):
        return stack

    def leaves(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), v

    flat = list(leaves(stack))
    depths = {v.shape[0] for _, v in flat}
    if depths != {n}:
        raise ValueError(f"{name} stacked over {sorted(depths)} layers, "
                         f"the config has {n}")
    out = [{} for _ in range(n)]
    for path, v in flat:
        for i, view in enumerate(torch.unbind(v, 0)):
            node = out[i]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = view
    return out


def _device(params: Params) -> torch.device:
    return params["embed"]["tok"].device


def _block(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
           ssm_state: Optional[torch.Tensor] = None,
           ssm_mask: Optional[torch.Tensor] = None,
           ssm_rows: Optional[torch.Tensor] = None,
           enc_out: Optional[torch.Tensor] = None,
           xcache: Optional[Dict[str, torch.Tensor]] = None, **attn_kw
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block: (x, the MoE layer's aux loss or None).  The SSD core's
    final state is written into ``ssm_state`` itself (none is kept when it
    is None), rows that ``ssm_mask`` leaves out keeping theirs, row b at
    ``ssm_rows[b]`` when given.  The hybrid block runs attention and SSD in
    parallel on separately normed inputs and adds both to the residual;
    a whisper decoder block then runs cross-attention; then the MLP or the
    MoE FFN, as the JAX ``block_apply`` does.  Cross-attention projects K/V
    from ``enc_out`` and writes them into the layer's cross cache
    ``xcache`` {"ck","cv"} (B, S_enc, nk, hd) when given, or, with no
    ``enc_out``, reads them from it (a decode step).  The MoE FFN routes
    every row of x, rows not decoding included, as the JAX decode step
    does: capacity is per routing call."""
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
    if "xattn" in lp:
        xn = L.rmsnorm(lp["lnx"], x, cfg.norm_eps)
        pos = attn_kw["positions"]
        if enc_out is None:
            xa = L.attention(lp["xattn"], xn, cfg, positions=pos,
                             causal=False,
                             precomputed_kv=(xcache["ck"], xcache["cv"]))
        elif xcache is None:
            xa = L.attention(lp["xattn"], xn, cfg, positions=pos,
                             causal=False, context=enc_out)
        else:
            xa, (k, v) = L.attention(lp["xattn"], xn, cfg, positions=pos,
                                     causal=False, context=enc_out,
                                     return_kv=True)
            if xcache is not None:
                xcache["ck"].copy_(k)
                xcache["cv"].copy_(v)
        x = x + xa
    aux = None
    if "moe" in lp:
        y, aux = _moe_fn(cfg, x)(
            lp["moe"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg)
        x = x + y
    elif "mlp" in lp:
        x = x + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps),
                      cfg.d_ff)
    return x, aux


def _moe_fn(cfg: ModelConfig, x: torch.Tensor):
    """The MoE layer a block runs, under the JAX model's condition: the
    ``moe_a2a`` schedule when the flag is set, a mesh with ``data`` is
    current and the tokens (the whole batch's: x holds this rank's data
    shard) divide over the a2a group; the dense layer otherwise."""
    if "moe_a2a" in cfg.perf_flags:
        from ..distributed import sharding as dist
        from .moe_a2a import a2a_active, a2a_axes, moe_block_a2a
        mesh = dist.current_mesh()
        if a2a_active(cfg, mesh):
            T = x.shape[0] * x.shape[1] * mesh.axis_size(
                [a for a in mesh.axis_names if a in ("pod", "data")])
            n_dev = mesh.axis_size(a2a_axes(mesh))
            if T % n_dev == 0 and T // n_dev >= 1:
                return moe_block_a2a
            if n_dev > 1:
                raise NotImplementedError(
                    f"{T} tokens do not divide over the {n_dev} ranks of "
                    "the moe_a2a group: the dense layer needs every "
                    "expert, and each rank holds its own")
    return moe_block


def _used(tree: Params, prefix: Tuple, lead: int = 0) -> Params:
    """``tree`` (the parameters' subtree at ``prefix``) as a layer uses
    it: under a mesh step's layout each FSDP leaf gathered whole along its
    batch-axis entries (``distributed.sharding.gather_for_use``), every
    other leaf as it is."""
    from ..distributed import sharding as dist
    layout = dist.current_layout()
    if layout is None or not layout.gathered:
        return tree
    return dist.gather_for_use(tree, layout, prefix, lead)


def _layer(lp: Params, x: torch.Tensor, cfg: ModelConfig, key: str, **kw):
    """:func:`_block` of layer views ``lp`` of the stack at ``key``, its
    FSDP leaves gathered first (:func:`_used`)."""
    return _block(_used(lp, (key,), 1), x, cfg, **kw)


def _remat(cfg: ModelConfig, lp: Params, x: torch.Tensor,
           key: str = "layers", **kw):
    """:func:`_layer` of a full-sequence forward; under ``remat="full"``,
    while autograd records, through ``torch.utils.checkpoint``: the block's
    activations are dropped and recomputed (the same kernel launches) in
    the backward, as ``jax.checkpoint`` does, and so are the layer's FSDP
    gathers: one layer's leaves are whole at a time."""
    if cfg.remat == "full" and L.recording(x, *tree_leaves(lp)):
        return torch.utils.checkpoint.checkpoint(
            _layer, lp, x, cfg, key, use_reentrant=False, **kw)
    return _layer(lp, x, cfg, key, **kw)


def _as(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def _long(x, dev: torch.device) -> torch.Tensor:
    return _as(x, dev, torch.long)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def _embed(params: Params, cfg: ModelConfig, tokens,
           patch_embeds) -> torch.Tensor:
    """Token embeddings (B, S, d) in the compute type; ``patch_embeds``
    (B', P, d), chameleon's precomputed VQ patch embeddings, replace those
    of rows :B' at positions :P (early fusion)."""
    dev = _device(params)
    tok = _used({"tok": params["embed"]["tok"]}, ("embed",))
    x = L.embed(tok, _long(tokens, dev), _dtype(cfg), cfg.vocab)
    if patch_embeds is not None:
        pe = _as(patch_embeds, dev, x.dtype)
        x[:pe.shape[0], :pe.shape[1]] = pe
    return x


def encode(params: Params, cfg: ModelConfig, enc_embeds) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings (B, S_enc, d):
    non-causal self-attention blocks at positions 0..S_enc-1, then
    ``enc_ln_f``; each layer's attention one K2 launch over all rows."""
    check_block(cfg)
    dev = _device(params)
    x = _as(enc_embeds, dev, _dtype(cfg))
    positions = torch.arange(x.shape[1], device=dev)
    for lp in layer_list(params["enc_layers"], cfg.encoder.layers,
                         "enc_layers"):
        x, _ = _remat(cfg, lp, x, "enc_layers", positions=positions,
                      causal=False)
    return L.rmsnorm(_used(params["enc_ln_f"], ("enc_ln_f",)), x,
                     cfg.norm_eps)


def _encoded(params: Params, cfg: ModelConfig,
             enc_embeds) -> Optional[torch.Tensor]:
    if cfg.encoder is None:
        return None
    if enc_embeds is None:
        raise ValueError(f"{cfg.name} needs encoder embeddings (enc_embeds)")
    return encode(params, cfg, enc_embeds)


def forward(params: Params, cfg: ModelConfig, tokens, *, enc_embeds=None,
            patch_embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward: tokens (B, S) -> (logits (B, S, V),
    the MoE layers' summed aux loss, f32; 0 without MoE).  ``enc_embeds``
    (B, S_enc, d), whisper's precomputed frame embeddings, go through the
    encoder first; ``patch_embeds`` as :func:`_embed` takes them.  In a
    mesh step (``distributed.sharding.use_mesh_rules`` with a layout)
    ``params`` are the rank's parts: each layer gathers its FSDP leaves on
    entry, and a vocab-sharded ``out`` gives the rank's vocab columns of
    the logits."""
    check_block(cfg)
    dev = _device(params)
    x = _embed(params, cfg, tokens, patch_embeds)
    enc_out = _encoded(params, cfg, enc_embeds)
    positions = torch.arange(x.shape[1], device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for lp in layer_list(params["layers"], cfg.layers):
        x, aux_l = _remat(cfg, lp, x, positions=positions, enc_out=enc_out)
        if aux_l is not None:
            aux = aux + aux_l
    x = L.rmsnorm(_used(params["ln_f"], ("ln_f",)), x, cfg.norm_eps)
    out = _used({"out": params["embed"]["out"]}, ("embed",))
    return L.unembed(out, x, cfg.vocab), aux


# ---------------------------------------------------------------------------
# Non-paged serving path: one contiguous cache row a sequence
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The non-paged decode cache, stacked over layers, with the JAX leaves
    and shapes: attention configs get "k", "v" (layers, batch, W, kv_heads,
    hd), W = min(window, max_len) for a windowed config (a ring) else
    max_len; SSM configs "ssm" (layers, batch, heads, state, hd) in f32;
    an encoder "ck", "cv" (layers, batch, S_enc, kv_heads, hd).  bf16 by
    default whatever ``cfg.dtype`` is, as in the JAX package."""
    check_block(cfg)
    dev = resolve_device(device)
    c: Dict[str, torch.Tensor] = {}

    def zeros(*shape, dtype=dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if has_attn(cfg):
        W = min(cfg.window, max_len) if cfg.window else max_len
        c["k"] = zeros(cfg.layers, batch, W, cfg.kv_heads, cfg.hd)
        c["v"] = zeros(cfg.layers, batch, W, cfg.kv_heads, cfg.hd)
    if has_ssm(cfg):
        s = cfg.ssm
        c["ssm"] = zeros(cfg.layers, batch, s.heads, s.state, s.head_dim,
                         dtype=torch.float32)
    if cfg.encoder is not None:
        S_enc = cfg.encoder.seq_len
        c["ck"] = zeros(cfg.layers, batch, S_enc, cfg.kv_heads, cfg.hd)
        c["cv"] = zeros(cfg.layers, batch, S_enc, cfg.kv_heads, cfg.hd)
    return c


def _layer_cache(cache: Dict[str, torch.Tensor], i: int,
                 keys: Tuple[str, ...]) -> Optional[Dict[str, torch.Tensor]]:
    """Layer i's slices of the cache leaves ``keys`` (views, written in
    place), or None when the cache has none."""
    return {k: cache[k][i] for k in keys} if keys[0] in cache else None


def _steps(params: Params, cfg: ModelConfig, x: torch.Tensor,
           cache: Dict[str, torch.Tensor], idx: torch.Tensor,
           positions: torch.Tensor,
           enc_out: Optional[torch.Tensor]) -> torch.Tensor:
    """The decoder layers over x at cache offset ``idx`` (0-d or (B,)),
    each writing its cache slices in place; returns the last rows'
    normed hidden state (B, 1, d)."""
    ssm = cache.get("ssm")
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(lp, x, cfg, ssm_state=ssm[i] if ssm is not None
                      else None, enc_out=enc_out,
                      xcache=_layer_cache(cache, i, ("ck", "cv")),
                      positions=positions,
                      cache=_layer_cache(cache, i, ("k", "v")),
                      cache_index=idx)
    return L.rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)


def prefill(params: Params, cfg: ModelConfig, tokens,
            cache: Dict[str, torch.Tensor], *, enc_embeds=None,
            patch_embeds=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill (B, S) prompts into a fresh :func:`init_cache` cache: their
    K/V go in at 0..S-1 (a ring keeps the last W), the SSM state of each
    row runs from the cache's, and with an encoder ``enc_embeds`` are
    encoded and each layer's cross K/V written to "ck"/"cv" in the cache's
    type.  As in the JAX layer, the prefill's cross-attention reads the
    unrounded cross K/V, a prompt on a ring its own unrounded K/V, and any
    other self-attention the cache it has just written.  Returns (last-token
    logits (B, V), cache); the next cache index is S."""
    check_block(cfg)
    dev = _device(params)
    x = _embed(params, cfg, tokens, patch_embeds)
    enc_out = _encoded(params, cfg, enc_embeds)
    positions = torch.arange(x.shape[1], device=dev)
    idx0 = torch.zeros((), dtype=torch.long, device=dev)
    x = _steps(params, cfg, x, cache, idx0, positions, enc_out)
    return L.unembed(params["embed"], x, cfg.vocab)[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, tokens,
                cache: Dict[str, torch.Tensor], cache_index
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: ``tokens`` (B, 1) at ``cache_index``, a scalar
    (every row at one offset) or (B,) (each row at its own, continuous
    batching) -> (logits (B, V), cache).  Cross-attention reads the cross
    K/V that :func:`prefill` cached, cast to the compute type.  Given
    tensors on the params' device, the step reads its index there and does
    no host work and no host-device copy, so a CUDA graph can capture it
    once and replay it on new contents of the same tensors."""
    dev = _device(params)
    x = L.embed(params["embed"], _long(tokens, dev), _dtype(cfg), cfg.vocab)
    idx = _long(cache_index, dev)
    positions = idx[:, None] if idx.dim() == 1 else idx.reshape(1)
    x = _steps(params, cfg, x, cache, idx, positions, None)
    return L.unembed(params["embed"], x, cfg.vocab)[:, 0], cache


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
    state, hd) in f32.  An SSM-only config holds no k/v pool; an
    encoder-decoder config is refused, as in the JAX package."""
    check_paged(cfg)
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
    x = L.embed(params["embed"], tokens.long(), _dtype(cfg), cfg.vocab)
    ssm = cache.get("ssm")
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(
            lp, x, cfg, ssm_state=ssm[i] if ssm is not None else None,
            ssm_rows=slot, positions=positions,
            cache=_layer_cache(cache, i, ("k", "v")),
            cache_index=idx, block_tables=block_table, lengths=lens)
    x = L.rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg.vocab)[:, 0], cache


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
    x = L.embed(params["embed"], tokens.long(), _dtype(cfg), cfg.vocab)
    positions = idx[:, None]
    ssm = cache.get("ssm")
    for i, lp in enumerate(params["layers"]):
        x, _ = _block(
            lp, x, cfg, ssm_state=ssm[i, :B] if ssm is not None else None,
            ssm_mask=active, positions=positions,
            cache=_layer_cache(cache, i, ("k", "v")),
            cache_index=idx, block_tables=block_tables, lengths=lens)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg.vocab)[:, 0], cache
