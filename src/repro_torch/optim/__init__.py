"""Optimizers, schedules, gradient clipping (the port of ``repro.optim``)."""
from .optimizers import (Optimizer, Part, adafactor, adamw,
                         clip_by_global_norm,
                         constant, global_norm, make_optimizer, tree_leaves,
                         tree_map, warmup_cosine)

__all__ = ["Optimizer", "Part", "adafactor", "adamw", "clip_by_global_norm",
           "constant", "global_norm", "make_optimizer", "tree_leaves",
           "tree_map", "warmup_cosine"]
