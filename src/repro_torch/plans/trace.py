"""Trace the exact kernel warm set the port's paged serve path dispatches.

The port's ops key dispatch on each call's own shape, as the JAX ops do, so
the warm set must hold exactly the shapes the port's model asks for — the
JAX trace warms matmul at ``M = max_len`` and attention at the block-grid
extent, shapes the port's model never dispatches (ROADMAP F5).  The paged
``attn_mlp`` serve path of :mod:`repro_torch.models.transformer` asks for:

- **prefill chunk** of length C (one sequence): the q/kv/out projections and
  the MLP at ``M = C``, the attention core at ``SQ = C``, and the lm_head at
  ``M = 1`` (only the last token is unembedded);
- **decode step** over the whole pool: projections, MLP and lm_head at
  ``M = max_batch``, and one attention core per decoding row at ``SQ = 1``.

C ranges over the scheduler's quantized chunk lengths: ``prefill_chunk``
and every power of two below it (capped by ``max_len``).  Nothing is
executed — this is an abstract walk of the step over shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

from ..models.config import ModelConfig


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


def chunk_lengths(prefill_chunk: int, max_len: int) -> List[int]:
    """The quantized prefill chunk lengths ``Scheduler._chunk_len`` can
    return: full chunks, then powers of two below ``prefill_chunk``."""
    out = {min(prefill_chunk, max_len)}
    p = 1
    while p < prefill_chunk and p <= max_len:
        out.add(p)
        p *= 2
    return sorted(out, reverse=True)


def _layer_requests(cfg: ModelConfig, M: int, prefix: str
                    ) -> Iterator[Tuple[str, str, Dict[str, int]]]:
    d, hd = cfg.d_model, cfg.hd
    yield (f"{prefix}.attn.q_proj", "matmul_h100",
           {"M": M, "N": cfg.heads * hd, "K": d})
    yield (f"{prefix}.attn.kv_proj", "matmul_h100",
           {"M": M, "N": cfg.kv_heads * hd, "K": d})
    yield (f"{prefix}.attn.out_proj", "matmul_h100",
           {"M": M, "N": d, "K": cfg.heads * hd})
    yield (f"{prefix}.mlp.up_proj", "matmul_h100",
           {"M": M, "N": cfg.d_ff, "K": d})       # wi and wg share it
    yield (f"{prefix}.mlp.down_proj", "matmul_h100",
           {"M": M, "N": d, "K": cfg.d_ff})


def _iter_requests(cfg: ModelConfig, *, max_len: int, max_batch: int,
                   prefill_chunk: int
                   ) -> Iterator[Tuple[str, str, Dict[str, int]]]:
    for c in chunk_lengths(prefill_chunk, max_len):
        pre = f"serve.prefill@{c}"
        yield from _layer_requests(cfg, c, pre)
        yield (f"{pre}.attn.core", "flash_attention_h100",
               {"SQ": c, "HD": cfg.hd})
        yield (f"{pre}.lm_head", "matmul_h100",
               {"M": 1, "N": cfg.vocab, "K": cfg.d_model})
    yield from _layer_requests(cfg, max_batch, "serve.decode")
    yield ("serve.decode.attn.core", "flash_attention_h100",
           {"SQ": 1, "HD": cfg.hd})
    yield ("serve.decode.lm_head", "matmul_h100",
           {"M": max_batch, "N": cfg.vocab, "K": cfg.d_model})


def trace_warm_set(cfg: ModelConfig, *, max_len: int = 512,
                   max_batch: int = 8, prefill_chunk: int = 32
                   ) -> List[TracedOp]:
    """The config's paged serve warm set: ordered, deduplicated by
    (family, data), deterministic."""
    if cfg.block != "attn_mlp":
        raise NotImplementedError(f"block {cfg.block!r} is not ported yet")
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
