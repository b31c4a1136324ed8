"""Resource and performance counters (paper §3.2-§3.3).

A counter pairs a *symbolic limit* (machine parameter ``R_i`` or ``P_i``)
with an *evaluation function* ``f_i``/``g_i`` mapping a kernel plan to a
polynomial (resource) or rational function (performance) in the program /
data / machine parameters — exactly the shape Remark 1 allows.

``sigma`` is the paper's ``σ(r_i)`` / ``σ(p_i)``: the subset of strategy
names with the potential to improve this counter.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Sequence, Tuple, TYPE_CHECKING

from .polynomial import Poly

if TYPE_CHECKING:  # pragma: no cover
    from .plan import FamilySpec, KernelPlan


class CounterKind(enum.Enum):
    RESOURCE = "resource"
    PERFORMANCE = "performance"


@dataclass(frozen=True)
class Counter:
    name: str
    kind: CounterKind
    limit_symbol: str                 # R_i name (resource) or P_i name (perf)
    sigma: Tuple[str, ...]            # strategies that may improve this counter
    doc: str = ""

    def evaluate(self, family: "FamilySpec", plan: "KernelPlan"
                 ) -> Tuple[Poly, Poly]:
        """Return (numerator, denominator) with denominator > 0 on-domain."""
        return family.counter_value(plan, self.name)


def resource(name: str, limit_symbol: str, sigma: Sequence[str], doc: str = ""
             ) -> Counter:
    return Counter(name, CounterKind.RESOURCE, limit_symbol, tuple(sigma), doc)


def performance(name: str, limit_symbol: str, sigma: Sequence[str],
                doc: str = "") -> Counter:
    return Counter(name, CounterKind.PERFORMANCE, limit_symbol, tuple(sigma),
                   doc)
