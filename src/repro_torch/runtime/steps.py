"""Step helpers of the port (``runtime/steps.py``): the non-paged serve
steps, their kernel warm-up, and greedy sampling; the train and eval steps
come with the training slice.

``build_serve_steps(cfg)`` is how whisper-large-v3 is served, as in the JAX
package (whose engine and launcher refuse encoder-decoder configs):
``prefill_step(params, tokens, cache, enc_embeds=...)`` then
``decode_one(params, tokens, cache, index)`` on a cache from
``models.init_cache``.  The decode step reads its index on the device and
does no host work, so a CUDA graph (``runtime.graph``) can capture it once
and replay it a token.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from ..artifacts.dispatch import get_default_cache
from ..core.params import H100_SXM, MachineDescription
from ..kernels.ops import FAMILIES
from ..models.config import ModelConfig
from ..models.transformer import decode_step, prefill
from ..plans.trace import TracedOp, trace_steps_warm_set


def build_serve_steps(cfg: ModelConfig) -> Tuple[Callable, Callable]:
    """(prefill_step, decode_one) of the non-paged serve path.

    prefill_step(params, tokens, cache[, enc_embeds/patch_embeds])
        -> (last_logits, cache)
    decode_one(params, tokens (B, 1), cache, index) -> (logits, cache)
    """

    def prefill_step(params, tokens, cache, **kw):
        return prefill(params, cfg, tokens, cache, **kw)

    def decode_one(params, tokens, cache, index):
        return decode_step(params, cfg, tokens, cache, index)

    return prefill_step, decode_one


def freeze_traced(ops: Sequence[TracedOp],
                  machine: MachineDescription) -> Dict[str, Any]:
    """Resolve every traced op through the process cache's tiers and pin
    them into its frozen lane; returns ``{label: {"candidate": Candidate,
    "rank_source": str}}``."""
    plan = get_default_cache().freeze(
        [(FAMILIES[op.family], machine, op.data_dict()) for op in ops])
    picks: Dict[str, Any] = {}
    for op in ops:
        ent = plan.get(op.family, machine.name, op.data_dict())
        picks[op.label] = {"candidate": ent.candidate,
                           "rank_source": ent.source}
    return picks


def warm_steps_dispatch(cfg: ModelConfig, *, batch: int, prompt_len: int,
                        max_len: int,
                        machine: MachineDescription = H100_SXM
                        ) -> Dict[str, Any]:
    """Freeze every kernel pick the non-paged steps ask for at (``batch``,
    ``prompt_len``, ``max_len``)
    (:func:`~repro_torch.plans.trace.trace_steps_warm_set`), as
    ``serving.warm_kernel_dispatch`` does for the engine; after it a
    prefill and the decode steps that follow resolve nothing cold."""
    return freeze_traced(trace_steps_warm_set(
        cfg, batch=batch, prompt_len=prompt_len, max_len=max_len), machine)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 argmax tokens (first maximum on ties,
    as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
