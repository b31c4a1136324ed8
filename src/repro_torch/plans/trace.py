"""Trace the exact kernel warm set the port's paged serve path dispatches.

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
and every power of two below it (capped by ``max_len``).  Nothing is
executed — this is an abstract walk of the step over shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

from ..models.config import ModelConfig
from ..models.moe import MOE_GROUP_SIZE, capacity
from ..models.transformer import check_block, has_attn, has_mlp, has_ssm


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
        """The products one launch at this key makes: E where a site runs
        K1's batched entry over the experts (a key a 2-D site shares needs
        no more), else 1."""
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


def _layer_requests(cfg: ModelConfig, M: int, SQ: int, prefix: str
                    ) -> Iterator[Tuple[str, str, Dict[str, int]]]:
    """One layer's requests over ``M`` token rows whose cores run at
    sequence length ``SQ`` (a prefill chunk: M = SQ = C; a decode step:
    M = max_batch, SQ = 1)."""
    d, hd = cfg.d_model, cfg.hd
    if has_attn(cfg):
        yield (f"{prefix}.attn.q_proj", "matmul_h100",
               {"M": M, "N": cfg.heads * hd, "K": d})
        yield (f"{prefix}.attn.kv_proj", "matmul_h100",
               {"M": M, "N": cfg.kv_heads * hd, "K": d})
        yield (f"{prefix}.attn.out_proj", "matmul_h100",
               {"M": M, "N": d, "K": cfg.heads * hd})
        yield (f"{prefix}.attn.core", "flash_attention_h100",
               {"SQ": SQ, "HD": hd, "GROUP": cfg.heads // cfg.kv_heads,
                "HK": cfg.kv_heads})
    if has_ssm(cfg):
        s = cfg.ssm
        di = s.heads * s.head_dim
        yield (f"{prefix}.ssm.x_proj", "matmul_h100",
               {"M": M, "N": di, "K": d})
        yield (f"{prefix}.ssm.bc_proj", "matmul_h100",
               {"M": M, "N": s.state, "K": d})    # wb and wc share it
        yield (f"{prefix}.ssm.decay_proj", "matmul_h100",
               {"M": M, "N": s.heads, "K": d})    # f32, from f32 wa
        yield (f"{prefix}.ssm.out_proj", "matmul_h100",
               {"M": M, "N": d, "K": di})
        yield (f"{prefix}.ssm.scan", "ssd_scan_h100",
               {"SQ": SQ, "HD": s.head_dim, "STATE": s.state})
    if has_mlp(cfg):
        yield (f"{prefix}.mlp.up_proj", "matmul_h100",
               {"M": M, "N": cfg.d_ff, "K": d})   # wi and wg share it
        yield (f"{prefix}.mlp.down_proj", "matmul_h100",
               {"M": M, "N": d, "K": cfg.d_ff})
    if cfg.block == "attn_moe":
        m = cfg.moe
        yield (f"{prefix}.moe.router", "matmul_h100",
               {"M": M, "N": m.num_experts, "K": d})
        gsz = min(MOE_GROUP_SIZE, M)
        cap = -(-M // gsz) * capacity(gsz, m.num_experts, m.top_k,
                                      m.capacity_factor)
        yield (f"{prefix}.moe.expert_up", "matmul_h100",
               {"M": cap, "N": m.d_ff_expert, "K": d})   # wi and wg
        yield (f"{prefix}.moe.expert_down", "matmul_h100",
               {"M": cap, "N": d, "K": m.d_ff_expert})


def _iter_requests(cfg: ModelConfig, *, max_len: int, max_batch: int,
                   prefill_chunk: int
                   ) -> Iterator[Tuple[str, str, Dict[str, int]]]:
    for c in chunk_lengths(prefill_chunk, max_len):
        pre = f"serve.prefill@{c}"
        yield from _layer_requests(cfg, c, c, pre)
        yield (f"{pre}.lm_head", "matmul_h100",
               {"M": 1, "N": cfg.vocab, "K": cfg.d_model})
    yield from _layer_requests(cfg, max_batch, 1, "serve.decode")
    yield ("serve.decode.lm_head", "matmul_h100",
           {"M": max_batch, "N": cfg.vocab, "K": cfg.d_model})


def trace_warm_set(cfg: ModelConfig, *, max_len: int = 512,
                   max_batch: int = 8, prefill_chunk: int = 32
                   ) -> List[TracedOp]:
    """The config's paged serve warm set: ordered, deduplicated by
    (family, data), deterministic."""
    check_block(cfg)
    out: List[TracedOp] = []
    index: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], int] = {}
    for site, family, data in _iter_requests(
            cfg, max_len=max_len, max_batch=max_batch,
            prefill_chunk=prefill_chunk):
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
