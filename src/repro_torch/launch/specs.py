"""Abstract training state and the gradient type of a config: the
single-card part of ``repro.launch.specs``, with no allocation.

``abstract_state`` builds the training state (and the optimizer's) on
PyTorch's ``meta`` device: every leaf has the JAX tree's shape and type and
no storage, so a 1T-parameter config is sized on any host.  The sharding
half of the JAX module (``NamedSharding`` trees, ZeRO-1 extensions, input
specs per mesh) has no single-card counterpart and is not ported.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import init_train_state
from ..optim import Optimizer

PyTree = Any


def abstract_state(cfg: ModelConfig, optimizer: Optional[Optimizer] = None
                   ) -> Tuple[PyTree, Optional[PyTree]]:
    """(params, opt_state) on the ``meta`` device: shapes and types only,
    zero allocation (``opt_state`` None without an optimizer)."""
    params = init_train_state(cfg, device="meta")
    return params, (optimizer.init(params) if optimizer is not None
                    else None)


def grad_dtype_for(cfg: ModelConfig) -> torch.dtype:
    """bf16 accumulators for the 1T MoE (f32 would not fit), as in the JAX
    package; f32 for every other config."""
    return torch.bfloat16 if cfg.name == "kimi-k2-1t-a32b" else torch.float32
