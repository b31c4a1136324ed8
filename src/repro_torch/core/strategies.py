"""Optimization strategies O_1..O_w (paper §3.4, §5).

The paper's implementation uses four strategy kinds — (i) register-pressure
reduction (3 levels), (ii) thread-granularity control, (iii) CSE (2 levels),
(iv) shared/local-memory caching.  We keep the same taxonomy with TPU
semantics:

  reduce_pressure_L{1,2,3}  : rematerialize / split the accumulation tile so
                              fewer live lane-values are held per grid step
                              (paper: fewer registers per thread).
  reduce_granularity        : shrink the per-grid-step output grain ``s``
                              (paper: reduce work per thread).
  cse_L{1,2}                : common-subexpression elimination on the index
                              arithmetic of the emitted kernel body.
  cache_vmem                : stage operand tiles in VMEM via BlockSpec
                              (paper: __shared__ staging via ``cache(a)``).

Each strategy is semantics-preserving on the plan (code soundness (ii)) and
idempotent per level (the paper's idempotence assumption): families encode
levels as monotone flags, so re-application at the same level is a no-op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .plan import KernelPlan

ApplyFn = Callable[[KernelPlan], Optional[KernelPlan]]


@dataclass(frozen=True)
class Strategy:
    """A named semantics-preserving plan transformation."""

    name: str
    apply: ApplyFn            # returns transformed plan, or None if not applicable
    doc: str = ""

    def __call__(self, plan: KernelPlan) -> Optional[KernelPlan]:
        return self.apply(plan)


# ---- generic flag-level helpers shared by kernel families -------------------

def level_strategy(name: str, flag: str, level: int, doc: str = "") -> Strategy:
    """Strategy that raises ``flag`` to ``level`` (idempotent, monotone)."""

    def apply(plan: KernelPlan) -> Optional[KernelPlan]:
        cur = plan.flags.get(flag, 0)
        if cur >= level:
            return None                      # idempotence: nothing further
        return plan.with_flag(flag, level, note=f"{name}")

    return Strategy(name, apply, doc)


def toggle_strategy(name: str, flag: str, value=True, doc: str = "") -> Strategy:
    def apply(plan: KernelPlan) -> Optional[KernelPlan]:
        if plan.flags.get(flag) == value:
            return None
        return plan.with_flag(flag, value, note=f"{name}")

    return Strategy(name, apply, doc)
