"""Comprehensive optimization — Algorithms 1 and 2 of the paper.

``comprehensive_optimization`` is Algorithm 1 (top level recursion over
quintuples); ``optimize`` is Algorithm 2 (evaluate the next counter, fork
accept / refuse branches, prune inconsistent constraint systems).

The output is the paper's comprehensive optimization of Definition 2: a
sequence of :class:`~repro_torch.core.plan.Leaf` pairs ``(C_i, S_i)`` satisfying

  (i)   constraint soundness — every kept system is consistent (or not
        provably inconsistent; see DESIGN.md §5 on the sound direction),
  (ii)  code soundness       — strategies are semantics-preserving,
  (iii) coverage             — accept/refuse add complementary constraints,
  (iv)  optimality           — along any path that exhausts σ(c), the final
        plan is a fix-point of every strategy in σ(c).

Tree shape properties proven in the paper (Lemmas 1-3) are enforced
structurally here and re-checked by tests/test_comprehensive.py.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .constraints import Constraint, ConstraintSystem, Verdict
from .counters import Counter, CounterKind
from .plan import FamilySpec, KernelPlan, Leaf, Quintuple
from .polynomial import Poly
from .strategies import Strategy


def initial_quintuple(family: FamilySpec,
                      domain_axioms: Sequence[Constraint] = ()) -> Quintuple:
    """Paper §3.6: λ empty, ω = O_1..O_w, γ = r_1..r_s,p_1..p_t, C = axioms."""
    counters = list(family.counters())
    strategies = list(family.strategies())
    C = ConstraintSystem()
    seen_limits = set()
    for c in counters:
        if c.limit_symbol in seen_limits:
            continue
        seen_limits.add(c.limit_symbol)
        if c.kind is CounterKind.PERFORMANCE:
            C.add(Constraint.ge(Poly.var(c.limit_symbol)))          # P_i >= 0
            C.add(Constraint.le(Poly.var(c.limit_symbol), 1))       # P_i <= 1
        else:
            C.add(Constraint.ge(Poly.var(c.limit_symbol)))          # R_i >= 0
    for ax in domain_axioms:
        C.add(ax)
    return Quintuple(
        plan=family.initial_plan(),
        lam=[],
        omega=[s.name for s in strategies],
        gamma=[c.name for c in counters],
        C=C,
    )


def _lookup(names: Sequence[str], table: Dict[str, object]) -> List[object]:
    return [table[n] for n in names]


def optimize(q: Quintuple, family: FamilySpec) -> List[Quintuple]:
    """Algorithm 2.  Returns the stack of child quintuples."""
    counters = {c.name: c for c in family.counters()}
    strategies = {s.name: s for s in family.strategies()}
    result: List[Quintuple] = []

    counter: Counter = counters[q.gamma[0]]
    q.gamma = q.gamma[1:]                # pop c from γ
    original = q.deepcopy()              # Line (5): fork material (post-pop)

    num, den = counter.evaluate(family, q.plan)
    limit = Poly.var(counter.limit_symbol)

    # ---- accept branch:  0 <= v <= Limit   (v = num/den, den > 0) ----------
    accept = q
    accept.C.add(Constraint.ge(num))                       # v >= 0
    accept.C.add(Constraint.ge(limit * den - num))         # v <= R_i / P_i
    result.append(accept)

    # ---- refuse branch: Limit < v, apply a strategy, re-evaluate c ---------
    applicable: Optional[Tuple[str, KernelPlan]] = None
    for s_name in original.omega:
        if s_name not in counter.sigma:
            continue
        transformed = strategies[s_name](original.plan)
        if transformed is not None:
            applicable = (s_name, transformed)
            break

    if applicable is not None:
        s_name, transformed = applicable
        refuse = original                                   # the deep copy
        refuse.C.add(Constraint.gt(num - limit * den))      # v > R_i / P_i
        if counter.kind is CounterKind.PERFORMANCE:
            refuse.C.add(Constraint.ge(den - num))          # v <= 1
        refuse.plan = transformed
        refuse.lam = refuse.lam + [s_name]
        refuse.omega = [n for n in refuse.omega if n != s_name]
        # push c back onto γ so the improved plan is re-measured
        refuse.gamma = [counter.name] + refuse.gamma
        result.append(refuse)

    # ---- prune inconsistent systems (paper R6 / RealTriangularize) ---------
    return [child for child in result if child.C.is_consistent()]


def comprehensive_optimization(family: FamilySpec,
                               domain_axioms: Sequence[Constraint] = (),
                               _q: Quintuple | None = None) -> List[Leaf]:
    """Algorithm 1.  Recursively process quintuples until γ is empty."""
    q = _q if _q is not None else initial_quintuple(family, domain_axioms)
    if q.processed():
        return [Leaf(constraints=q.C, plan=q.plan, applied=tuple(q.lam))]
    leaves: List[Leaf] = []
    for child in optimize(q, family):
        leaves.extend(
            comprehensive_optimization(family, domain_axioms, _q=child))
    return leaves


# ----------------------------------------------------------------------------
# Cached per-family trees: building the tree is an offline, machine-free step
# (the whole point of the paper); every runtime caller reuses it.  Leaf
# identity matters downstream — the compiled-system cache in
# repro_torch.core.compiled keys on constraint-system identity, so serving the
# same list object keeps specializations shared across calls.
# ----------------------------------------------------------------------------
_TREE_CACHE: Dict[str, List[Leaf]] = {}
_TREE_LOCK = threading.Lock()


def comprehensive_tree(family: FamilySpec,
                       domain_axioms: Sequence[Constraint] = ()) -> List[Leaf]:
    key = family.name + "::" + ";".join(map(repr, domain_axioms))
    with _TREE_LOCK:
        hit = _TREE_CACHE.get(key)
    if hit is None:
        hit = comprehensive_optimization(family, domain_axioms)
        with _TREE_LOCK:
            hit = _TREE_CACHE.setdefault(key, hit)
    return hit


def clear_tree_cache() -> None:
    """Drop memoized trees (tests / families redefined at runtime)."""
    with _TREE_LOCK:
        _TREE_CACHE.clear()


def tree_report(leaves: Sequence[Leaf]) -> str:
    """Human-readable case discussion (paper Fig. 2 / Fig. 7 / Fig. 8)."""
    out = []
    for i, leaf in enumerate(leaves, 1):
        out.append(f"case {i}: {leaf.plan.describe()}")
        out.append(f"  applied: {', '.join(leaf.applied) or '(none)'}")
        for atom in leaf.constraints.atoms:
            out.append(f"  s.t. {atom}")
    return "\n".join(out)
