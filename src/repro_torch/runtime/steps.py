"""Step helpers of the port (``runtime/steps.py``): greedy sampling only in
this slice; the train and eval steps come with the training slice."""
from __future__ import annotations

import torch


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 argmax tokens (first maximum on ties,
    as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
