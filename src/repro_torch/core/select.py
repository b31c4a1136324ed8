"""Load-time leaf selection and offline auto-tuning (paper §1, §4).

The comprehensive tree is built offline with every parameter symbolic.  When
the artifact is *loaded* on a concrete machine we:

1. substitute the machine bindings (``MachineDescription.bindings()``) into
   every leaf's constraint system and drop leaves that become inconsistent;
2. substitute the data parameters (matrix order, sequence length, ...);
3. enumerate feasible integer assignments of the remaining program
   parameters from their domains, filtered by the leaf constraints;
4. rank candidates with the paper-style performance counters (occupancy ×
   MXU utilization), entirely offline — or with a wall-clock ``runner`` when
   the caller wants empirical auto-tuning (benchmarks do this on CPU).

The cold path is served by the compiled-evaluation subsystem
(:mod:`repro_torch.core.compiled`): each leaf's constraint system is specialized
against the machine+data binding *once*, the program-parameter cross-product
is materialized as integer arrays, and a vectorized screen decides all rows
at one go — only rows the float arithmetic cannot certify fall back to exact
``Fraction`` work.  ``use_compiled=False`` (or ``REPRO_COMPILED=0``) forces
the original per-candidate exact path, kept as the parity oracle; the
property tests assert both paths select identical candidates.

This file is what the rest of the framework calls: every perf-critical op
asks ``best_variant(family, machine, data)`` for its kernel configuration.
Ranking preference order: a *measured* (hardware-calibrated) rank from a
tuned dispatch table when one covers the bucket (``scripts/
tune_artifacts.py``, :mod:`repro.tuning`), else the symbolic offline model —
the fallback chain lives in :class:`repro_torch.artifacts.dispatch.DispatchCache`.
"""
from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .compiled import CompiledSystem
from .comprehensive import comprehensive_tree
from .constraints import ConstraintSystem, Verdict
from .counters import CounterKind
from .params import MachineDescription
from .plan import FamilySpec, KernelPlan, Leaf

#: Process default for the vectorized cold path; REPRO_COMPILED=0 disables.
USE_COMPILED = os.environ.get("REPRO_COMPILED", "1").lower() not in (
    "0", "false", "no")


@dataclass
class SelectStats:
    """Process-wide instrumentation for the dispatch layers.

    ``enumerate_calls`` counts *cold* candidate enumerations — the expensive
    tree-search path the artifact/dispatch cache exists to amortize away.
    Tests assert on it; benchmarks report it.  The remaining fields profile
    the compiled cold path itself: how many rows went through the vectorized
    screen, how many needed the exact-Fraction fallback, and how many leaves
    could not be classified and ran the reference loop.
    """

    enumerate_calls: int = 0
    compiled_leaves: int = 0        # leaves decided by the vectorized screen
    fallback_leaves: int = 0        # leaves that ran the exact reference loop
    rows_screened: int = 0          # program-param rows batch-screened
    rows_emitted: int = 0           # candidates surviving screen + verify
    last_enumerate_seconds: float = 0.0

    def reset(self) -> None:
        self.enumerate_calls = 0
        self.compiled_leaves = 0
        self.fallback_leaves = 0
        self.rows_screened = 0
        self.rows_emitted = 0
        self.last_enumerate_seconds = 0.0


STATS = SelectStats()


@dataclass(frozen=True)
class Candidate:
    """A fully bound kernel variant ready to instantiate."""

    leaf_index: int
    plan: KernelPlan
    assignment: Dict[str, int]            # program-parameter values
    score: float                          # higher is better (offline model)

    def describe(self) -> str:
        asg = ", ".join(f"{k}={v}" for k, v in sorted(self.assignment.items()))
        return f"{self.plan.describe()} @ {{{asg}}} score={self.score:.4g}"


def bind(machine: MachineDescription,
         data: Mapping[str, int]) -> Dict[str, int]:
    """The machine bindings with the data parameters beside them.

    Raises ``ValueError`` when a data key names a machine symbol: merged
    over the machine it would silently replace the machine's limit (a
    Jacobi step count passed as ``"T"`` would become the threads a block).
    The JAX package merges without this check; its machines bind no ``T``.
    """
    machine_values = machine.bindings()
    clash = sorted(set(data) & set(machine_values))
    if clash:
        raise ValueError(
            f"data keys {clash} name machine symbols of {machine.name} "
            f"({sorted(machine_values)}); pass only data parameters")
    return {**machine_values, **{k: int(v) for k, v in data.items()}}


def specialize(leaves: Sequence[Leaf], machine: MachineDescription,
               data: Mapping[str, int]) -> List[Tuple[int, Leaf, ConstraintSystem]]:
    """Bind machine + data parameters; keep not-provably-inconsistent leaves."""
    binding = bind(machine, data)
    kept = []
    for i, leaf in enumerate(leaves):
        C = leaf.constraints.subs(binding)
        if C.check() is not Verdict.INCONSISTENT:
            kept.append((i, leaf, C))
    return kept


def _perf_score(family: FamilySpec, plan: KernelPlan,
                values: Mapping[str, int]) -> float:
    """Offline model: product of performance-counter values clipped to 1.

    Families may provide a richer napkin-math model via ``score(plan, values)``
    (used for ranking only — feasibility always comes from the constraint
    tree, never from the score).
    """
    if hasattr(family, "score"):
        return float(family.score(plan, values))
    score = 1.0
    for c in family.counters():
        if c.kind is not CounterKind.PERFORMANCE:
            continue
        num, den = c.evaluate(family, plan)
        try:
            n = float(num.eval(values))
            d = float(den.eval(values))
        except KeyError:
            continue
        if d <= 0:
            return 0.0
        score *= min(1.0, max(0.0, n / d))
    return score


def _perf_score_batch(family: FamilySpec, plan: KernelPlan,
                      binding: Mapping[str, int],
                      cols: Mapping[str, np.ndarray],
                      n_rows: int) -> np.ndarray:
    """Batched scoring over ``n_rows`` program-parameter assignments.

    Families may expose ``score_batch(plan, values)`` over NumPy columns (the
    vectorized twin of ``score``); otherwise the scalar model runs per row —
    the row count here is already small (feasible candidates only)."""
    if hasattr(family, "score_batch"):
        values = {**binding, **{k: np.asarray(v) for k, v in cols.items()}}
        return np.broadcast_to(
            np.asarray(family.score_batch(plan, values), dtype=np.float64),
            (n_rows,))
    if hasattr(family, "score"):
        out = np.empty(n_rows, dtype=np.float64)
        for r in range(n_rows):
            values = {**binding, **{k: int(cols[k][r]) for k in cols}}
            out[r] = float(family.score(plan, values))
        return out
    # counter-product model, batched through the compiled evaluators
    score = np.ones(n_rows, dtype=np.float64)
    ccols = {**binding, **cols}
    for c in family.counters():
        if c.kind is not CounterKind.PERFORMANCE:
            continue
        num, den = c.evaluate(family, plan)
        try:
            n = np.broadcast_to(num.compile().eval_batch(ccols), (n_rows,))
            d = np.broadcast_to(den.compile().eval_batch(ccols), (n_rows,))
        except KeyError:
            continue
        bad = d <= 0
        ratio = np.clip(np.divide(n, d, out=np.zeros(n_rows),
                                  where=~bad), 0.0, 1.0)
        score = np.where(bad, 0.0, score * ratio)
    return score


# ---------------------------------------------------------------------------
# Cold-path enumeration: compiled (vectorized) and reference (exact) twins
# ---------------------------------------------------------------------------

def _enumerate_leaf_reference(family: FamilySpec, binding: Mapping[str, int],
                              idx: int, leaf: Leaf, C: ConstraintSystem,
                              max_per_leaf: int) -> List[Candidate]:
    """Original per-candidate exact loop for one machine+data-bound leaf."""
    out: List[Candidate] = []
    names = sorted(leaf.plan.program_params)
    domains = [leaf.plan.program_params[n].feasible() for n in names]
    count = 0
    for combo in itertools.product(*domains):
        if count >= max_per_leaf:
            break
        asg = dict(zip(names, combo))
        full = {**binding, **asg}
        # After machine+data+program binding the only free symbols are the
        # performance measures P_i in [0,1]; every atom is then constant
        # or univariate-linear, so the check below is a decision.
        if C.subs(asg).check(samples=64) is Verdict.INCONSISTENT:
            continue
        count += 1
        out.append(Candidate(
            leaf_index=idx,
            plan=leaf.plan,
            assignment=asg,
            score=_perf_score(family, leaf.plan, full),
        ))
    return out


#: Rows screened per vectorized batch: bounds peak memory on leaves whose
#: domain product is huge, and lets ``max_per_leaf`` stop the sweep early
#: (the reference loop's lazy-exit behaviour, chunked).
_SCREEN_CHUNK = 1 << 16


def _enumerate_leaf_compiled(family: FamilySpec, binding: Mapping[str, int],
                             idx: int, leaf: Leaf, cs: CompiledSystem,
                             max_per_leaf: int) -> List[Candidate]:
    """Vectorized enumeration of one leaf's program-parameter cross-product."""
    if cs.infeasible or max_per_leaf <= 0:
        return []
    names = sorted(leaf.plan.program_params)
    domains = [cs.filter_domain(n, leaf.plan.program_params[n].feasible())
               for n in names]
    if any(not d for d in domains):
        return []
    if not names:
        # no program parameters: the specialized system is fully decided
        score = _perf_score_batch(family, leaf.plan, binding, {}, 1)
        return [Candidate(leaf_index=idx, plan=leaf.plan, assignment={},
                          score=float(score[0]))]
    dom_arrays = [np.asarray(d, dtype=np.int64) for d in domains]
    shape = tuple(len(d) for d in domains)
    total = int(np.prod(shape))
    maxvals = {n: max(d) for n, d in zip(names, domains)}
    out: List[Candidate] = []
    # walk the cross-product in itertools.product order (C-order row ids),
    # one bounded chunk at a time
    for start in range(0, total, _SCREEN_CHUNK):
        stop = min(start + _SCREEN_CHUNK, total)
        multi = np.unravel_index(np.arange(start, stop), shape)
        cols = {n: dom_arrays[i][multi[i]] for i, n in enumerate(names)}
        n_rows = stop - start
        STATS.rows_screened += n_rows
        mask = cs.feasible_rows(cols, maxvals, n_rows)
        sel = np.flatnonzero(mask)[:max_per_leaf - len(out)]
        if sel.size:
            sel_cols = {n: cols[n][sel] for n in names}
            scores = _perf_score_batch(family, leaf.plan, binding, sel_cols,
                                       int(sel.size))
            for j in range(sel.size):
                asg = {n: int(sel_cols[n][j]) for n in names}
                out.append(Candidate(leaf_index=idx, plan=leaf.plan,
                                     assignment=asg, score=float(scores[j])))
        if len(out) >= max_per_leaf:
            break
    return out


def enumerate_candidates(family: FamilySpec,
                         machine: MachineDescription,
                         data: Mapping[str, int],
                         max_per_leaf: int = 512,
                         leaves: Optional[Sequence[Leaf]] = None,
                         use_compiled: Optional[bool] = None
                         ) -> List[Candidate]:
    """Cold-path enumeration over the comprehensive tree.

    ``leaves`` lets the artifact layer supply a disk-loaded tree instead of
    rebuilding in-process (the offline/online split of paper §1).
    ``use_compiled`` picks the vectorized cold path (default: module flag
    ``USE_COMPILED``); both paths return the identical candidate list — the
    reference path exists as the oracle the property tests compare against.
    """
    STATS.enumerate_calls += 1
    t0 = time.perf_counter()
    if use_compiled is None:
        use_compiled = USE_COMPILED
    binding = bind(machine, data)
    if leaves is None:
        leaves = comprehensive_tree(family)
    out: List[Candidate] = []
    if use_compiled:
        for idx, leaf in enumerate(leaves):
            cs = leaf.constraints.specialize(binding)
            names = set(leaf.plan.program_params)
            if cs.fallback or not cs.row_vars <= names:
                # unclassifiable residual atoms (or residual symbols the
                # cross-product will not bind): exact loop for this leaf
                STATS.fallback_leaves += 1
                C = leaf.constraints.subs(binding)
                if C.check() is not Verdict.INCONSISTENT:
                    out.extend(_enumerate_leaf_reference(
                        family, binding, idx, leaf, C, max_per_leaf))
                continue
            STATS.compiled_leaves += 1
            out.extend(_enumerate_leaf_compiled(
                family, binding, idx, leaf, cs, max_per_leaf))
    else:
        for idx, leaf, C in specialize(leaves, machine, data):
            out.extend(_enumerate_leaf_reference(
                family, binding, idx, leaf, C, max_per_leaf))
    STATS.rows_emitted += len(out)
    STATS.last_enumerate_seconds = time.perf_counter() - t0
    return out


def rank_candidates(family: FamilySpec,
                    machine: MachineDescription,
                    data: Mapping[str, int],
                    leaves: Optional[Sequence[Leaf]] = None,
                    max_per_leaf: int = 512) -> List[Candidate]:
    """Enumerate + sort (best first).  Raises if nothing is feasible."""
    cands = enumerate_candidates(family, machine, data,
                                 max_per_leaf=max_per_leaf, leaves=leaves)
    if not cands:
        raise ValueError(
            f"no feasible kernel variant for family={family.name} "
            f"machine={machine.name} data={dict(data)}")
    cands.sort(key=lambda c: c.score, reverse=True)
    return cands


def best_variant(family: FamilySpec,
                 machine: MachineDescription,
                 data: Mapping[str, int],
                 runner: Optional[Callable[[Candidate], float]] = None,
                 top_k: int = 4,
                 *, use_cache: bool = True) -> Candidate:
    """Pick the kernel variant for this machine + data.

    The fully-static path (no ``runner``) is served by the process-wide
    :class:`repro_torch.artifacts.dispatch.DispatchCache` — memory LRU, then disk
    artifact, then cold rebuild — so a recurring (family, machine, data)
    triple costs a dict lookup, not a tree search.  A disk table tuned by
    ``scripts/tune_artifacts.py`` carries measured per-bucket ranks; those
    take precedence over the symbolic score, falling back to the symbolic
    order for untuned tables/buckets.  ``use_cache=False`` forces
    the cold path (the cache itself uses it, as do A/B tests).

    ``runner`` (optional) measures wall-clock seconds for a candidate; when
    provided, the offline model shortlists ``top_k`` and the runner decides
    (classic auto-tuning, paper §1).  Empirical timings are machine-state
    dependent, so that path bypasses the cache.
    """
    if runner is None and use_cache:
        from ..artifacts.dispatch import get_default_cache
        return get_default_cache().best_variant(family, machine, data)
    cands = rank_candidates(family, machine, data)
    if runner is None:
        return cands[0]
    short = cands[:top_k]
    timed = [(runner(c), c) for c in short]
    timed.sort(key=lambda t: t[0])
    return timed[0][1]


def case_table(family: FamilySpec, machine: MachineDescription,
               datasets: Sequence[Mapping[str, int]]) -> List[Tuple[Dict, Candidate]]:
    """Paper Table-1-style report: best variant per input size."""
    return [(dict(d), best_variant(family, machine, d)) for d in datasets]
