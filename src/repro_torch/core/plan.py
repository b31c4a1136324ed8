"""Kernel plans and the optimization quintuple (paper §3.6).

The paper's unit of work is a *quintuple* ``Q(S) = (G_C(S), λ, ω, γ, C)``:
the source CFG, the strategies already applied, the strategies still
available, the counters still to evaluate, and the constraint system built so
far.

On the TPU side the "code fragment" is a :class:`KernelPlan`: a symbolic
description of one Pallas kernel variant — which caching/granularity/CSE/
pressure transformations have been applied (``flags``) and which program
parameters remain symbolic (``program_params``).  A plan is *enough* to
(a) evaluate every resource/performance counter as a polynomial and
(b) instantiate a concrete ``pl.pallas_call`` once parameters are bound.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Mapping, Optional, Protocol, Sequence, Tuple

from .constraints import Constraint, ConstraintSystem
from .polynomial import Poly


@dataclass(frozen=True)
class ParamDomain:
    """Feasible values a program parameter may take at instantiation time."""

    name: str
    candidates: Tuple[int, ...]          # e.g. powers of two
    align: int = 1                       # hardware alignment requirement

    def feasible(self) -> Tuple[int, ...]:
        return tuple(c for c in self.candidates if c % self.align == 0)


@dataclass
class KernelPlan:
    """One symbolic kernel variant (the paper's code fragment S_i)."""

    family: str                                   # e.g. "matmul"
    flags: Dict[str, Any] = field(default_factory=dict)
    program_params: Dict[str, ParamDomain] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    def clone(self) -> "KernelPlan":
        return KernelPlan(
            family=self.family,
            flags=dict(self.flags),
            program_params=dict(self.program_params),
            notes=list(self.notes),
        )

    def with_flag(self, key: str, value: Any, note: str | None = None
                  ) -> "KernelPlan":
        p = self.clone()
        p.flags[key] = value
        if note:
            p.notes.append(note)
        return p

    def describe(self) -> str:
        flg = ", ".join(f"{k}={v}" for k, v in sorted(self.flags.items()))
        return f"{self.family}[{flg}]"


class FamilySpec(Protocol):
    """What a kernel family (kernels/<name>.py) must expose to the core."""

    name: str

    def initial_plan(self) -> KernelPlan: ...

    def counters(self) -> Sequence["Any"]:
        """Ordered resource+performance counters (core.counters.Counter)."""

    def strategies(self) -> Sequence["Any"]:
        """Ordered optimization strategies (core.strategies.Strategy)."""

    def counter_value(self, plan: KernelPlan, counter: str
                      ) -> Tuple[Poly, Poly]:
        """Symbolic (numerator, denominator) of a counter on this plan.
        Denominator must be positive on the domain (Remark 1)."""


@dataclass
class Quintuple:
    """Paper §3.6 ``Q(S)``; sequences behave as stacks (Remark 2)."""

    plan: KernelPlan                      # G_C(S) stand-in
    lam: List[str]                        # λ — applied strategies (history)
    omega: List[str]                      # ω — remaining strategy names (stack)
    gamma: List[str]                      # γ — remaining counter names (stack)
    C: ConstraintSystem                   # constraints accumulated so far

    def processed(self) -> bool:
        return not self.gamma

    def deepcopy(self) -> "Quintuple":
        return Quintuple(
            plan=self.plan.clone(),
            lam=list(self.lam),
            omega=list(self.omega),
            gamma=list(self.gamma),
            C=self.C.copy(),
        )


@dataclass(frozen=True)
class Leaf:
    """A processed quintuple == one (C_i, S_i) pair of Definition 2."""

    constraints: ConstraintSystem
    plan: KernelPlan
    applied: Tuple[str, ...]              # λ — the optimization recipe

    def __repr__(self) -> str:
        return (f"Leaf(plan={self.plan.describe()}, applied={self.applied}, "
                f"C={self.constraints})")
