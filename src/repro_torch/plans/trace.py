"""Trace the exact kernel warm set the port's serve paths dispatch: the
paged engine's (:func:`trace_warm_set`) and the non-paged steps'
(:func:`trace_steps_warm_set`).

The port's ops key dispatch on each call's own shape, as the JAX ops do, so
the warm set must hold exactly the shapes the port's model asks for — the
JAX trace warms matmul at ``M = max_len`` and attention at the block-grid
extent, shapes the port's model never dispatches, and leaves out the f32
SSM decay projection (ROADMAP F5).  The paged serve path of
:mod:`repro_torch.models.transformer` asks, for each block it has, for:

- **prefill chunk** of length C (one sequence): the q/kv/out projections,
  the SSM x/B/C/decay/out projections and the MLP at ``M = C``, the
  attention core at ``SQ = C`` (with ``GROUP`` = heads / kv_heads and
  ``HK`` = kv_heads, since K/V reach it unbroadcast), the SSD scan at
  ``SQ = C``, the MoE router at ``M = C`` and the experts' SwiGLU at
  ``M = capacity(C, E, k, cf)`` (a chunk is one routing group), and the
  lm_head at ``M = 1`` (only the last token is unembedded);
- **decode step** over the whole pool: projections, MLP, router and
  lm_head at ``M = max_batch``, the experts at ``M = capacity(max_batch,
  E, k, cf)``, one paged attention core over all rows at ``SQ = 1``, and
  one SSD scan over all rows at ``SQ = 1``.

The experts' ``expert_up`` (``wi`` and ``wg``) and ``expert_down`` keys are
per expert, as the JAX trace keys them; the model launches each through
K1's batched entry over all E experts (:meth:`TracedOp.experts`).

C ranges over the scheduler's quantized chunk lengths: ``prefill_chunk``
and every power of two below it (capped by ``max_len``).

The non-paged steps (``models.transformer.prefill`` and ``decode_step``,
whisper's only serve path) of a batch of B prompts of S tokens ask for:

- **encode** (an encoder config): every encoder layer's projections and
  MLP at ``M = B·S_enc``, its attention core at ``SQ = S_enc`` (one launch
  over all rows), where the JAX trace lists ``M = S_enc``;
- **prefill**: each decoder layer's requests at ``M = B·S``, its cores at
  ``SQ = S``; the cross-attention's q and out projections at ``M = B·S``,
  its K/V projection over the encoder output at ``M = B·S_enc``, its core
  at ``SQ`` = each run of at most S_enc queries; the lm_head at ``M = B``;
- **decode step**: the layers at ``M = B``, every core at ``SQ = 1``, the
  cross-attention's q and out projections (its K/V are cached) and the
  lm_head at ``M = B``.

A train step (:func:`trace_train_warm_set`) of ``global_batch`` rows of
``seq`` tokens in ``microbatches`` runs each microbatch of R = global_batch
/ microbatches rows forward and backward: the layers' requests at ``M =
R·seq`` (an encoder's at ``M = R·S_enc``, its cores at ``SQ = S_enc``; the
cross-attention's K/V over ``M = R·S_enc``), the cores at ``SQ = seq``, and
the lm_head over every token, ``M = R·seq``.  Every K1 request (M, N, K) of
the forward also asks, in the backward (``kernels/autograd.py``), for dA =
dC·Bᵀ at (M, K, N) and dB = Aᵀ·dC at (K, N, M), and for K4's transposes of
B [K, N] and of A [M, K]; every attention core asks for K2b at K2's key,
and every SSD scan for K3b at K3's.  The MoE router is such a K1 request
(its dA at (T, d, E), its dB at (d, E, T)); the experts' products ask for
their dA, dB and transposes at the per-expert keys, and the model launches
each through the batched entries of K1 and K4 (``BatchedMatmulFn``), so
:meth:`TracedOp.experts` gives E for every one of those sites.  Under a
mesh each rank runs its rows of a microbatch, and a ``moe_a2a`` config its
routing groups: the router at the rank's T / n tokens, the experts at
``M = G·C`` (every group's capacity rows of the rank's experts).  The
dense MoE layer under a mesh routes the rank's tokens where they are whole
groups (the experts then at every group's rows of the rank's experts,
``M = n_e·G_l·C`` over n_e expert shards) and the microbatch's T tokens
otherwise (the experts at ``M = G·C``).  On a ``model`` axis of t ranks
the rank's tensor-parallel keys: ``wq``, ``wk``, ``wv`` (the
cross-attention's and the encoder's too), ``wi``, ``wg``, the experts'
``wi``, ``wg``, the SSD block's ``wx``, ``wb``, ``wc``, ``wa`` and the
lm_head at N / t, the row-parallel ``wo``s at K / t (a dim t does not
divide stays whole; the SSD ``wo`` at the rank's d_inner columns,
``layers.ssm_tp_plan``), K2 and K2b at the heads the rank computes; K3's
key does not name its heads.

Nothing is executed — this is an abstract walk of the step over shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..kernels.flash_attention_bwd import launches_a_call
from ..kernels.ssd_scan_bwd import LAUNCHES_A_CALL
from ..models.config import ModelConfig
from ..models.layers import ssm_tp_plan, tp_heads
from ..models.moe import MOE_GROUP_SIZE, a2a_padded_experts, capacity
from ..models.moe_a2a import a2a_active, a2a_axes
from ..models.transformer import (check_block, check_mesh, check_paged,
                                  check_train, has_attn, has_mlp, has_ssm)


def op_label(family: str, data: Dict[str, int]) -> str:
    """Canonical label for a traced (family, data) pair, e.g.
    ``matmul_h100@K4096xM32xN14336``."""
    return family + "@" + "x".join(f"{k}{int(v)}"
                                   for k, v in sorted(data.items()))


@dataclass(frozen=True)
class TracedOp:
    """One deduplicated warm-set member and every call site asking for it."""

    label: str
    family: str
    data: Tuple[Tuple[str, int], ...]        # sorted items, hashable
    sites: Tuple[str, ...]

    def data_dict(self) -> Dict[str, int]:
        return dict(self.data)

    def experts(self, cfg: ModelConfig) -> int:
        """The products (or transposes) one launch at this key makes: E
        where a site runs K1's or K4's batched entry over the experts (the
        forward's and the backward's expert sites; a key a 2-D site shares
        needs no more), else 1."""
        return cfg.moe.num_experts if any(
            ".moe.expert_" in s for s in self.sites) else 1


def chunk_lengths(prefill_chunk: int, max_len: int) -> List[int]:
    """The quantized prefill chunk lengths ``Scheduler._chunk_len`` can
    return: full chunks, then powers of two below ``prefill_chunk``."""
    out = {min(prefill_chunk, max_len)}
    p = 1
    while p < prefill_chunk and p <= max_len:
        out.add(p)
        p *= 2
    return sorted(out, reverse=True)


def _split(n: int, tp: Optional[Tuple[int, int]]) -> int:
    """A dim of ``n`` as a rank of ``tp`` = (t, j) along ``model`` holds
    it: ``n / t`` where t divides it (its spec shards it), else whole."""
    return n // tp[0] if tp is not None and n % tp[0] == 0 else n


def _heads(cfg: ModelConfig, SQ: int, tp: Optional[Tuple[int, int]]
           ) -> Dict[str, int]:
    """K2's key for an attention core at ``SQ`` queries over the heads the
    rank of ``tp`` computes (``layers.tp_heads``), all heads without."""
    hd, nq = cfg.hd, cfg.heads * cfg.hd
    if tp is not None and _split(nq, tp) != nq:
        plan = tp_heads(cfg, *tp)
        h = plan["h1"] - plan["h0"]
        return {"SQ": SQ, "HD": hd, "GROUP": plan["group"],
                "HK": h // plan["group"]}
    return {"SQ": SQ, "HD": hd, "GROUP": cfg.heads // cfg.kv_heads,
            "HK": cfg.kv_heads}


Request = Tuple[str, str, Dict[str, int], Dict]


def _layer_requests(cfg: ModelConfig, M: int, SQ: int, prefix: str,
                    a2a: Optional[Tuple[int, int]] = None,
                    tp: Optional[Tuple[int, int]] = None,
                    ep: Optional[Tuple[int, int]] = None, *,
                    causal: bool = True, kv: Optional[Tuple[int, int]] = None
                    ) -> Iterator[Request]:
    """One layer's requests over ``M`` token rows whose cores run at
    sequence length ``SQ`` (a prefill chunk: M = SQ = C; a decode step:
    M = max_batch, SQ = 1).  ``a2a`` = (T, n): the MoE layer runs the
    ``moe_a2a`` schedule over n ranks for a batch of T tokens.  ``tp`` =
    (t, j): rank j of t along ``model`` (tensor parallelism): the
    column-parallel projections at their N / t, the row-parallel at their
    K / t, the attention core at the rank's heads (``layers.tp_heads``),
    the SSD block's as ``layers.ssm_tp_plan`` cuts it.  ``ep`` = (n_b,
    n_e): the dense MoE layer of a rank of n_b batch ranks (M its tokens)
    whose experts lie over n_e expert shards.  Each request carries what
    a launch's work depends on (:class:`Launch`): its launches a call of
    the layer (``n``: ``wk`` and ``wv`` are two), a K1 request's input
    type where it is not the config's (the f32 decay projection), the
    experts of a batched launch, a core's rows, its keys (``kv`` = (keys a
    row's pool holds, keys it reads), the core's own SQ without a cache)
    and masks, and the SSD heads the rank scans."""
    d, hd = cfg.d_model, cfg.hd
    sk, klen = kv if kv is not None else (SQ, SQ)
    rows = M // SQ
    if has_attn(cfg):
        nq, nk = cfg.heads * hd, cfg.kv_heads * hd
        heads = _heads(cfg, SQ, tp)
        yield (f"{prefix}.attn.q_proj", "matmul_h100",
               {"M": M, "N": _split(nq, tp), "K": d}, {})
        yield (f"{prefix}.attn.kv_proj", "matmul_h100",
               {"M": M, "N": _split(nk, tp), "K": d}, {"n": 2})
        yield (f"{prefix}.attn.out_proj", "matmul_h100",
               {"M": M, "N": d, "K": _split(nq, tp)}, {})
        yield (f"{prefix}.attn.core", "flash_attention_h100", heads,
               {"rows": rows, "sk": sk, "len": klen, "causal": causal,
                "window": cfg.window})
    if has_ssm(cfg):
        s = cfg.ssm
        di = s.heads * s.head_dim
        plan = ssm_tp_plan(cfg, *tp) if tp is not None else None
        sp = tp if plan is not None else None
        yield (f"{prefix}.ssm.x_proj", "matmul_h100",
               {"M": M, "N": _split(di, sp), "K": d}, {})
        yield (f"{prefix}.ssm.bc_proj", "matmul_h100",
               {"M": M, "N": _split(s.state, sp), "K": d},
               {"n": 2})                                    # wb and wc
        yield (f"{prefix}.ssm.decay_proj", "matmul_h100",
               {"M": M, "N": _split(s.heads, sp), "K": d},
               {"dtype": "float32"})                        # f32, f32 wa
        yield (f"{prefix}.ssm.out_proj", "matmul_h100",
               {"M": M, "N": d, "K": plan["c1"] - plan["c0"]
                if plan is not None else di}, {})
        yield (f"{prefix}.ssm.scan", "ssd_scan_h100",
               {"SQ": SQ, "HD": s.head_dim, "STATE": s.state},
               {"rows": rows, "H": plan["h1"] - plan["h0"]
                if plan is not None else s.heads})
    if has_mlp(cfg):
        yield (f"{prefix}.mlp.up_proj", "matmul_h100",
               {"M": M, "N": _split(cfg.d_ff, tp), "K": d},
               {"n": 2})                                    # wi and wg
        yield (f"{prefix}.mlp.down_proj", "matmul_h100",
               {"M": M, "N": d, "K": _split(cfg.d_ff, tp)}, {})
    if cfg.block == "attn_moe":
        m = cfg.moe
        fe = m.d_ff_expert
        if a2a is None:
            n_b, n_e = ep if ep is not None else (1, 1)
            T = M * n_b                       # the microbatch's tokens
            gsz = min(MOE_GROUP_SIZE, T)
            whole = n_b > 1 and M % gsz != 0  # routed whole on every rank
            routed = T if whole else M
            groups = -(-routed // gsz) * (1 if whole else n_e)
            fe = _split(fe, tp)
            held = m.num_experts // n_e
        else:                         # this rank's groups; every group's
            T, n = a2a                # rows of its experts
            gsz = min(MOE_GROUP_SIZE, max(1, T // n))
            routed, groups = T // n, T // gsz
            held = -(-a2a_padded_experts(cfg) // n)
        yield (f"{prefix}.moe.router", "matmul_h100",
               {"M": routed, "N": m.num_experts, "K": d}, {})
        cap = groups * capacity(gsz, m.num_experts, m.top_k,
                                m.capacity_factor)
        yield (f"{prefix}.moe.expert_up", "matmul_h100",
               {"M": cap, "N": fe, "K": d}, {"n": 2, "E": held})  # wi, wg
        yield (f"{prefix}.moe.expert_down", "matmul_h100",
               {"M": cap, "N": d, "K": fe}, {"E": held})


def _iter_requests(cfg: ModelConfig, *, max_len: int, max_batch: int,
                   prefill_chunk: int) -> Iterator[Request]:
    for c in chunk_lengths(prefill_chunk, max_len):
        pre = f"serve.prefill@{c}"
        yield from _layer_requests(cfg, c, c, pre)
        yield (f"{pre}.lm_head", "matmul_h100",
               {"M": 1, "N": cfg.vocab, "K": cfg.d_model}, {})
    yield from _layer_requests(cfg, max_batch, 1, "serve.decode")
    yield ("serve.decode.lm_head", "matmul_h100",
           {"M": max_batch, "N": cfg.vocab, "K": cfg.d_model}, {})


def _cross_requests(cfg: ModelConfig, M: int, SQ: int, kv_rows: int,
                    prefix: str, tp: Optional[Tuple[int, int]] = None
                    ) -> Iterator[Request]:
    """A whisper decoder layer's cross-attention over ``M`` token rows of
    ``SQ`` queries a sequence: q and out projections, the K/V projection
    over ``kv_rows`` encoder rows (none at decode: they are cached), and
    the core at each query run of at most S_enc (``tp``: a rank's, as
    :func:`_layer_requests` takes it)."""
    d, hd, sk = cfg.d_model, cfg.hd, cfg.encoder.seq_len
    nq, nk = cfg.heads * hd, cfg.kv_heads * hd
    yield (f"{prefix}.xattn.q_proj", "matmul_h100",
           {"M": M, "N": _split(nq, tp), "K": d}, {})
    if kv_rows:
        yield (f"{prefix}.xattn.kv_proj", "matmul_h100",
               {"M": kv_rows, "N": _split(nk, tp), "K": d}, {"n": 2})
    yield (f"{prefix}.xattn.out_proj", "matmul_h100",
           {"M": M, "N": d, "K": _split(nq, tp)}, {})
    runs = [min(sk, SQ - s) for s in range(0, SQ, sk)]
    for run in sorted(set(runs), reverse=True):
        yield (f"{prefix}.xattn.core", "flash_attention_h100",
               _heads(cfg, run, tp),
               {"n": runs.count(run), "rows": M // SQ, "sk": sk,
                "len": sk, "causal": False, "window": None})


def _iter_step_requests(cfg: ModelConfig, *, batch: int, prompt_len: int,
                        max_len: Optional[int] = None,
                        tp: Optional[Tuple[int, int]] = None,
                        ep: Optional[Tuple[int, int]] = None,
                        a2a: Optional[Tuple[int, int]] = None,
                        parts: Tuple[str, ...] = ("prefill", "decode")
                        ) -> Iterator[Request]:
    """The non-paged steps' requests: ``parts`` of "prefill" (the
    encoder's too) and "decode" (a step at the last index of a cache of
    ``max_len``), ``tp``, ``ep`` and ``a2a`` a rank's as
    :func:`_layer_requests` takes them, ``batch`` the rank's rows."""
    enc = cfg.encoder
    enc_rows = batch * enc.seq_len if enc is not None else 0
    max_len = max_len or prompt_len
    W = min(cfg.window, max_len) if cfg.window else max_len
    ring = cfg.window is not None and W <= cfg.window
    if "prefill" in parts:
        if enc is not None:
            yield from _layer_requests(cfg, enc_rows, enc.seq_len,
                                       "serve.encode", tp=tp, ep=ep,
                                       causal=False)
        pre = f"serve.prefill@{prompt_len}"
        # a prompt on a ring attends within itself; any other reads the
        # cache it has just written, up to its length
        kv = (prompt_len, prompt_len) if ring else (W, prompt_len)
        yield from _layer_requests(cfg, batch * prompt_len, prompt_len, pre,
                                   a2a, tp, ep, kv=kv)
        if enc is not None:
            yield from _cross_requests(cfg, batch * prompt_len, prompt_len,
                                       enc_rows, pre, tp)
        yield (f"{pre}.lm_head", "matmul_h100",
               {"M": batch, "N": _split(cfg.vocab, tp), "K": cfg.d_model},
               {})
    if "decode" in parts:
        kv = (W, min(max_len, W))
        for req in _layer_requests(cfg, batch, 1, "serve.decode", a2a, tp,
                                   ep, kv=kv):
            if ring and req[1] == "flash_attention_h100":
                req = (req[0], req[1], req[2], dict(req[3], causal=False,
                                                    window=None))
            yield req
        if enc is not None:
            yield from _cross_requests(cfg, batch, 1, 0, "serve.decode", tp)
        yield ("serve.decode.lm_head", "matmul_h100",
               {"M": batch, "N": _split(cfg.vocab, tp), "K": cfg.d_model},
               {})


def _dedup(requests: Iterator[Tuple[str, str, Dict[str, int]]]
           ) -> List[TracedOp]:
    """Ordered, deduplicated by (family, data), each op with every site
    asking for it."""
    out: List[TracedOp] = []
    index: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], int] = {}
    for site, family, data, *_ in requests:
        items = tuple(sorted((k, int(v)) for k, v in data.items()))
        key = (family, items)
        at = index.get(key)
        if at is None:
            index[key] = len(out)
            out.append(TracedOp(label=op_label(family, data), family=family,
                                data=items, sites=(site,)))
        else:
            prev = out[at]
            out[at] = TracedOp(label=prev.label, family=prev.family,
                               data=prev.data, sites=prev.sites + (site,))
    return out


def trace_warm_set(cfg: ModelConfig, *, max_len: int = 512,
                   max_batch: int = 8, prefill_chunk: int = 32
                   ) -> List[TracedOp]:
    """The config's paged serve warm set: ordered, deduplicated by
    (family, data), deterministic.  An encoder-decoder config is refused:
    the paged path does not serve it."""
    check_paged(cfg)
    return _dedup(_iter_requests(cfg, max_len=max_len, max_batch=max_batch,
                                 prefill_chunk=prefill_chunk))


def trace_steps_warm_set(cfg: ModelConfig, *, batch: int, prompt_len: int,
                         max_len: int) -> List[TracedOp]:
    """The warm set of the non-paged steps for ``batch`` prompts of
    ``prompt_len`` tokens prefilled into a cache of ``max_len`` and then
    decoded: ordered, deduplicated by (family, data), deterministic."""
    check_block(cfg)
    if not 0 < prompt_len <= max_len:
        raise ValueError(f"prompt length {prompt_len} not in 1..{max_len}")
    return _dedup(_iter_step_requests(cfg, batch=batch,
                                      prompt_len=prompt_len))


def _iter_train_requests(cfg: ModelConfig, *, rows: int, seq: int,
                         a2a: Optional[Tuple[int, int]] = None,
                         tp: Optional[Tuple[int, int]] = None,
                         ep: Optional[Tuple[int, int]] = None
                         ) -> Iterator[Request]:
    """A microbatch's forward requests (``tp``, ``ep``: a rank's, as
    :func:`_layer_requests` takes them; the lm_head at its vocab / t)."""
    enc = cfg.encoder
    enc_rows = rows * enc.seq_len if enc is not None else 0
    if enc is not None:
        yield from _layer_requests(cfg, enc_rows, enc.seq_len, "train.encode",
                                   tp=tp, causal=False)
    yield from _layer_requests(cfg, rows * seq, seq, "train.layer", a2a, tp,
                               ep)
    if enc is not None:
        yield from _cross_requests(cfg, rows * seq, seq, enc_rows,
                                   "train.layer", tp)
    yield ("train.lm_head", "matmul_h100",
           {"M": rows * seq, "N": _split(cfg.vocab, tp), "K": cfg.d_model},
           {})


#: The backward family of each forward family but K1's, at the forward's
#: key: K2b for K2, K3b for K3.
BACKWARD = {"flash_attention_h100": "flash_attention_bwd_h100",
            "ssd_scan_h100": "ssd_scan_bwd_h100"}


def _with_backward(requests: Iterator[Request]) -> Iterator[Request]:
    """Each forward request, then what its backward asks for (a K1
    request's dA, dB and K4's two transposes, as many as it has calls);
    raises for a family whose backward it does not know."""
    for site, family, data, *rest in requests:
        info = dict(rest[0]) if rest else {}
        yield site, family, data, info
        back = dict(info, backward=True)
        if family == "matmul_h100":
            M, N, K = data["M"], data["N"], data["K"]
            yield f"{site}.dA", family, {"M": M, "N": K, "K": N}, back
            yield f"{site}.dB", family, {"M": K, "N": N, "K": M}, back
            yield f"{site}.wT", "transpose_h100", {"M": K, "N": N}, back
            yield f"{site}.xT", "transpose_h100", {"M": M, "N": K}, back
        elif family in BACKWARD:
            yield f"{site}.bwd", BACKWARD[family], data, back
        else:
            raise ValueError(f"{site}: no backward of family {family!r} "
                             "is known")


def _train_requests(cfg: ModelConfig, global_batch: int, seq: int,
                    microbatches: int, mesh) -> Iterator[Request]:
    """A rank's requests in one microbatch of a train step over ``mesh``,
    forward and backward."""
    check_train(cfg)
    shards, tp = 1, None
    if mesh is not None:
        check_mesh(cfg, mesh)
        shards = mesh.axis_size([a for a in ("pod", "data")
                                 if a in mesh.axis_names])
        if mesh.shape.get("model", 1) > 1:
            tp = (mesh.shape["model"], mesh.coords()["model"])
    if global_batch % (microbatches * shards):
        raise ValueError(f"batch {global_batch} not a multiple of "
                         f"{microbatches} microbatches of {shards} shards")
    rows = global_batch // microbatches // shards
    return _with_backward(_iter_train_requests(
        cfg, rows=rows, seq=seq, tp=tp,
        **_rank_moe(cfg, mesh, rows * seq * shards, shards)))


def _rank_moe(cfg: ModelConfig, mesh, tokens: int, shards: int
              ) -> Dict[str, Optional[Tuple[int, int]]]:
    """The MoE layer's ``a2a`` or ``ep`` argument of a rank of ``mesh``
    whose batch is ``tokens`` over ``shards`` row shards."""
    if a2a_active(cfg, mesh):
        return {"a2a": (tokens, mesh.axis_size(a2a_axes(mesh)))}
    if mesh is not None and cfg.block == "attn_moe":
        n = mesh.shape.get("data", 1)
        return {"ep": (shards, n if cfg.moe.num_experts % n == 0 else 1)}
    return {}


def trace_train_warm_set(cfg: ModelConfig, *, global_batch: int, seq: int,
                         microbatches: int = 1, mesh=None) -> List[TracedOp]:
    """The warm set of a train step: ordered, deduplicated by (family,
    data), deterministic.  A config the port does not train is refused.
    Under a ``mesh`` (the step's) a rank runs its rows of each microbatch,
    and a ``moe_a2a`` config's MoE layers the schedule: the router at the
    rank's tokens (over every pod, the batch's T over the ("data",
    "model") ranks: each pod routes every group), the experts at every
    group's rows (G·C a key, over the rank's E_l experts, which the key
    does not name), and the dense MoE layer its expert parallelism
    (:func:`_layer_requests`' ``ep``); with ``model`` > 1 the rank's
    tensor-parallel keys (``tp``, the mesh's rank: rank 0 of an abstract
    mesh)."""
    return _dedup(_train_requests(cfg, global_batch, seq, microbatches,
                                  mesh))


# ---------------------------------------------------------------------------
# Every launch of one step, with its count
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Launch:
    """A kernel launch site of one step and how often the step makes it:
    ``calls`` requests of the dispatch ``family`` at ``key`` (what a
    ``DispatchCache.record()`` counts), ``launches`` kernels of the
    wrapper that counts them (``wrapper``: ``matmul_h100_batched`` and
    ``transpose_h100_batched`` for the experts' batched entries; K2b and
    K3b launch several kernels a call), and ``info``, what the launch's
    work depends on beyond its key (:func:`~repro_torch.launch.roofline.
    launch_signature`)."""

    site: str
    family: str
    wrapper: str
    key: Tuple[Tuple[str, int], ...]
    calls: int
    launches: int
    info: Dict


def _launches(cfg: ModelConfig, requests: Iterator[Request], times
              ) -> List[Launch]:
    """Each request as a :class:`Launch`, its calls ``times(site, info)``
    times its ``n``."""
    cdt = getattr(torch, cfg.dtype)
    out = []
    for site, family, data, info in requests:
        info = dict(info)
        info["dtype"] = getattr(torch, info.get("dtype", cfg.dtype))
        wrapper = family
        if "E" in info and family in ("matmul_h100", "transpose_h100"):
            wrapper += "_batched"
        calls = info.pop("n", 1) * times(site, info)
        per = (launches_a_call(cdt) if family == "flash_attention_bwd_h100"
               else LAUNCHES_A_CALL if family == "ssd_scan_bwd_h100" else 1)
        out.append(Launch(site, family, wrapper,
                          tuple(sorted((k, int(v)) for k, v in data.items())),
                          calls, calls * per, info))
    return out


def trace_train_launches(cfg: ModelConfig, *, global_batch: int, seq: int,
                         microbatches: int = 1, mesh=None) -> List[Launch]:
    """Every launch of one train step of a rank, in request order, not
    deduplicated: the warm set's requests (:func:`trace_train_warm_set`)
    of each layer times the layers (a whisper encoder's times its own),
    each product's and core's as many as it has calls, every microbatch;
    under ``remat="full"`` a block's forward runs again in the backward,
    so its forward launches count twice (the lm_head's once), as
    ``torch.utils.checkpoint`` recomputes it."""
    enc = cfg.encoder.layers if cfg.encoder is not None else 0
    remat = 2 if cfg.remat == "full" else 1

    def times(site: str, info: Dict) -> int:
        depth = (cfg.layers if site.startswith("train.layer.") else
                 enc if site.startswith("train.encode.") else 0)
        again = remat if depth and not info.get("backward") else 1
        return microbatches * max(depth, 1) * again

    return _launches(cfg, _train_requests(cfg, global_batch, seq,
                                          microbatches, mesh), times)


def trace_serve_launches(cfg: ModelConfig, *, batch: int, prompt_len: int,
                         max_len: int, part: str, mesh=None
                         ) -> List[Launch]:
    """Every launch of one non-paged serve step of a rank: ``part``
    "prefill" (``batch`` prompts of ``prompt_len`` tokens into a cache of
    ``max_len``, the encoder first) or "decode" (one token a row at the
    cache's last index), each layer's requests times the layers; under
    ``mesh`` the rank's rows (``launch.specs.batch_entry``) and its
    tensor-parallel keys and experts."""
    check_block(cfg)
    tp = moe = None
    if mesh is not None:
        check_mesh(cfg, mesh)
        from ..distributed.sharding import entry_axes
        from ..launch.specs import batch_entry
        shards = mesh.axis_size(entry_axes(batch_entry(mesh, batch)))
        if mesh.shape.get("model", 1) > 1:
            tp = (mesh.shape["model"], mesh.coords()["model"])
        tokens = batch * (prompt_len if part == "prefill" else 1)
        moe = _rank_moe(cfg, mesh, tokens, shards)
        batch //= shards
    enc = cfg.encoder.layers if cfg.encoder is not None else 0

    def times(site: str, info: Dict) -> int:
        return (enc if site.startswith("serve.encode.") else
                1 if site.endswith(".lm_head") else cfg.layers)

    return _launches(cfg, _iter_step_requests(
        cfg, batch=batch, prompt_len=prompt_len, max_len=max_len, tp=tp,
        parts=(part,), **(moe or {})), times)
