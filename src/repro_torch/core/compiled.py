"""Compiled evaluation for the symbolic core (specialize-once, batch-eval).

The comprehensive tree is built once per family with every parameter
symbolic; resolving it for a concrete (machine, data) binding used to pay
per-candidate exact ``Fraction`` substitution — seconds per cold dispatch.
This module lowers the symbolic objects to flat array programs the way
KLARAPTOR (arXiv:1911.02373) compiles its rational programs before sweeping
the launch-parameter lattice:

``CompiledPoly``
    a polynomial lowered to parallel (coefficient, monomial) arrays with a
    NumPy batched evaluator, plus the original :class:`Poly` for the
    exact-Fraction single-point fallback.  Coefficients are scaled to
    integers (lcm of denominators), so over integer assignments the float64
    evaluation is *exact* whenever a precomputed magnitude bound certifies
    every intermediate stays below 2**53.

``CompiledSystem``
    a constraint system partial-evaluated against a machine+data binding
    *once*, with residual atoms classified (constant / row-parameter /
    measure-linear / general) and per-program-parameter integer bounds
    precomputed.  ``feasible_rows`` then decides a whole cross-product of
    program-parameter assignments in a handful of vectorized passes,
    replicating exactly the inconsistency proofs of
    :meth:`ConstraintSystem.check` (constant refutation + interval-box
    emptiness); rows it cannot certify fall back to the exact path.

Variable-domain convention (paper hypothesis H1): names starting with
``P_`` are performance measures — rationals in ``[0, 1]``; every other
variable ranges over the non-negative integers.  See
:func:`repro_torch.core.constraints.is_integer_var`.

Invariants (docs/architecture.md restates these; tests enforce them):

- **float64-exactness certificate** — the vectorized evaluators only trust
  a float64 result when the precomputed magnitude bound proves every
  intermediate stays below 2**53; anything the certificate cannot cover
  runs the exact ``Fraction`` fallback.  Speed never changes an answer.
- **screen parity** — ``CompiledSystem.feasible_rows`` replicates exactly
  the INCONSISTENT proofs of :meth:`ConstraintSystem.check` (constant
  refutation + interval-box emptiness), nothing more; the per-candidate
  reference loop remains the parity oracle
  (``use_compiled=False`` / ``REPRO_COMPILED=0``,
  tests/test_select_parity.py).
- **no semantic drift without a version bump** — any change that alters a
  canonical tree's bytes (e.g. a new bound-tightening rule) must bump
  ``repro.artifacts.serde.FORMAT_VERSION`` (ROADMAP policy).
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from fractions import Fraction
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .constraints import _DEFAULT_HI, ConstraintSystem, Rel, is_integer_var
from .polynomial import Monomial, Poly

# float64 represents every integer with |x| < 2**53 exactly; products/sums
# certified below this bound are exact integer arithmetic.
_EXACT_LIMIT = 1 << 53


class CompiledPoly:
    """A Poly lowered to a flat coefficient/monomial array program.

    ``scale`` is an integer multiple of the lcm of coefficient denominators;
    the *scaled* evaluators compute ``scale * poly(x)``, which is an integer
    for integer assignments.  Two CompiledPolys built with a shared scale
    (see :func:`compile_pair`) can be compared/cross-multiplied exactly.
    """

    __slots__ = ("poly", "names", "monos", "coeffs_int", "coeffs", "scale")

    def __init__(self, poly: Poly, scale: Optional[int] = None):
        self.poly = poly
        self.names = tuple(sorted(poly.variables()))
        denom = 1
        for c in poly.terms.values():
            denom = math.lcm(denom, c.denominator)
        if scale is None:
            scale = denom
        elif scale % denom:
            raise ValueError(f"scale {scale} incompatible with lcm {denom}")
        self.scale = scale
        monos = tuple(sorted(poly.terms))
        self.monos: Tuple[Monomial, ...] = monos
        self.coeffs_int = tuple(
            int(poly.terms[m] * scale) for m in monos)
        # float64 image of the scaled coefficients; exactness of batched
        # evaluation is certified via max_abs_scaled, never assumed here
        self.coeffs = np.array([float(c) for c in self.coeffs_int]
                               if monos else [], dtype=np.float64)

    # -- batched evaluation --------------------------------------------------
    def eval_batch_scaled(self, cols: Mapping[str, np.ndarray]) -> np.ndarray:
        """``scale * poly`` over a batch; ``cols`` maps var -> array/scalar."""
        acc: np.ndarray | float = 0.0
        for coeff, mono in zip(self.coeffs, self.monos):
            term: np.ndarray | float = coeff
            for var, exp in mono:
                if var not in cols:
                    raise KeyError(f"unbound variable {var!r} in {self.poly}")
                col = cols[var]
                term = term * (col ** exp if exp > 1 else col)
            acc = acc + term
        return np.asarray(acc, dtype=np.float64)

    def eval_batch(self, cols: Mapping[str, np.ndarray]) -> np.ndarray:
        """True (unscaled) float64 values for a batch of assignments."""
        out = self.eval_batch_scaled(cols)
        return out / self.scale if self.scale != 1 else out

    # -- exactness certificate ----------------------------------------------
    def max_abs_scaled(self, maxvals: Mapping[str, int]) -> int:
        """Upper bound (exact int) on |scale * poly| over ``|var| <= maxval``.

        Uses ``max(|maxval|, 1)`` per variable so the bound also dominates
        every intermediate term/partial sum: below 2**53 the float64 batched
        evaluation over integer columns is exact integer arithmetic."""
        bound = 0
        for c, mono in zip(self.coeffs_int, self.monos):
            t = abs(c)
            for var, exp in mono:
                t *= max(abs(int(maxvals[var])), 1) ** exp
            bound += t
        return bound

    # -- exact fallback ------------------------------------------------------
    def eval_exact(self, assignment: Mapping[str, object]) -> Fraction:
        return self.poly.eval(assignment)

    def __repr__(self) -> str:
        return f"CompiledPoly({self.poly!r}, scale={self.scale})"


def compile_pair(a: Poly, b: Poly) -> Tuple[CompiledPoly, CompiledPoly]:
    """Compile two polys with one shared scale (exact cross-comparisons)."""
    denom = 1
    for p in (a, b):
        for c in p.terms.values():
            denom = math.lcm(denom, c.denominator)
    return CompiledPoly(a, scale=denom), CompiledPoly(b, scale=denom)


# ---------------------------------------------------------------------------
# Residual-atom classification
# ---------------------------------------------------------------------------

class _RowAtom:
    """Residual atom over row (program) variables only: sign test per row."""

    __slots__ = ("cpoly", "rel")

    def __init__(self, cpoly: CompiledPoly, rel: Rel):
        self.cpoly = cpoly
        self.rel = rel


class _MeasureAtom:
    """Residual atom ``k(row) * m + c(row) REL 0`` for one measure var m.

    ``k`` and ``c`` share one scale, so the bound ``-c/k`` is a ratio of the
    scaled integer evaluations with the scale cancelled."""

    __slots__ = ("var", "k", "c", "rel")

    def __init__(self, var: str, k: CompiledPoly, c: CompiledPoly, rel: Rel):
        self.var = var
        self.k = k
        self.c = c
        self.rel = rel


def _const_holds(c: Fraction, rel: Rel) -> bool:
    if rel is Rel.GE:
        return c >= 0
    if rel is Rel.GT:
        return c > 0
    return c == 0


def _rel_mask(vals: np.ndarray, rel: Rel) -> np.ndarray:
    if rel is Rel.GE:
        return vals >= 0
    if rel is Rel.GT:
        return vals > 0
    return vals == 0


class _Interval:
    """Exact rational interval with strict flags, mirroring Box semantics:
    lower default 0 (non-strict), upper default ``_DEFAULT_HI``."""

    __slots__ = ("lo", "hi", "lo_strict", "hi_strict")

    def __init__(self):
        self.lo = Fraction(0)
        self.hi = Fraction(_DEFAULT_HI)
        self.lo_strict = False
        self.hi_strict = False

    def add(self, k: Fraction, c: Fraction, rel: Rel, integer: bool) -> None:
        """Tighten with ``k*m + c REL 0`` (k != 0)."""
        bound = -c / k
        if rel is Rel.EQ:
            self._raise_lo(bound, False)
            self._lower_hi(bound, False)
        elif k > 0:
            if rel is Rel.GT and integer:
                self._raise_lo(Fraction(math.floor(bound) + 1), False)
            else:
                self._raise_lo(bound, rel is Rel.GT)
        else:
            if rel is Rel.GT and integer:
                self._lower_hi(Fraction(math.ceil(bound) - 1), False)
            else:
                self._lower_hi(bound, rel is Rel.GT)

    def _raise_lo(self, val: Fraction, strict: bool) -> None:
        if val > self.lo:
            self.lo, self.lo_strict = val, strict
        elif val == self.lo and strict:
            self.lo_strict = True

    def _lower_hi(self, val: Fraction, strict: bool) -> None:
        if val < self.hi:
            self.hi, self.hi_strict = val, strict
        elif val == self.hi and strict:
            self.hi_strict = True

    def empty(self) -> bool:
        return (self.lo > self.hi
                or (self.lo == self.hi and (self.lo_strict or self.hi_strict)))


class CompiledSystem:
    """A constraint system specialized against one machine+data binding.

    Classification of each atom after folding the binding in:

    * **constant** — decided here; a false one marks the system infeasible;
    * **row atom** — residual vars are all integer-domain (program params):
      a vectorized sign test per enumerated row;
    * **measure atom** — linear in exactly one ``P_*`` measure variable with
      row-only coefficients: contributes to an interval-emptiness test that
      replicates ``_propagate_bounds``;
    * anything else sets ``fallback`` and the caller must use the exact path.

    ``int_bounds`` holds the integer lower/upper bounds implied by
    univariate-linear row atoms — callers may prune enumeration domains with
    them (rows outside the bounds provably fail the corresponding atom).
    """

    __slots__ = ("binding", "infeasible", "fallback", "row_vars", "row_atoms",
                 "measure_atoms", "int_bounds")

    def __init__(self, system: ConstraintSystem, binding: Mapping[str, int]):
        self.binding = dict(binding)
        self.infeasible = False
        self.fallback = False
        self.row_vars: frozenset = frozenset()
        self.row_atoms: List[_RowAtom] = []
        self.measure_atoms: Dict[str, List[_MeasureAtom]] = {}
        row_vars = set()
        for atom in system.atoms:
            p = atom.poly.subs(binding)
            pvars = p.variables()
            if not pvars:
                if not _const_holds(p.constant_value(), atom.rel):
                    self.infeasible = True
                continue
            measures = {v for v in pvars if not is_integer_var(v)}
            if not measures:
                self.row_atoms.append(_RowAtom(p.compile(), atom.rel))
                row_vars |= pvars
                continue
            if len(measures) != 1:
                self.fallback = True
                continue
            (m,) = measures
            if p.degree(m) != 1:
                self.fallback = True
                continue
            k_terms: Dict[Monomial, Fraction] = {}
            c_terms: Dict[Monomial, Fraction] = {}
            for mono, coeff in p.terms.items():
                rest = tuple((v, e) for v, e in mono if v != m)
                if len(rest) == len(mono):
                    c_terms[mono] = coeff
                else:
                    k_terms[rest] = coeff
            k_poly, c_poly = Poly(k_terms), Poly(c_terms)
            k_cp, c_cp = compile_pair(k_poly, c_poly)
            self.measure_atoms.setdefault(m, []).append(
                _MeasureAtom(m, k_cp, c_cp, atom.rel))
            row_vars |= k_poly.variables() | c_poly.variables()
        self.row_vars = frozenset(row_vars)
        self._settle_constant_measures()
        self.int_bounds = self._integer_bounds()

    # -- specialize-time decisions -------------------------------------------
    def _settle_constant_measures(self) -> None:
        """Decide measure vars whose atoms are all binding-constant."""
        for m in list(self.measure_atoms):
            atoms = self.measure_atoms[m]
            if not all(a.k.poly.is_constant() and a.c.poly.is_constant()
                       for a in atoms):
                continue
            iv = _Interval()
            for a in atoms:
                k = a.k.poly.terms.get((), Fraction(0))
                c = a.c.poly.terms.get((), Fraction(0))
                if k == 0:
                    if not _const_holds(c, a.rel):
                        self.infeasible = True
                else:
                    iv.add(k, c, a.rel, is_integer_var(m))
            if iv.empty():
                self.infeasible = True
            del self.measure_atoms[m]     # same verdict for every row

    def _integer_bounds(self) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
        out: Dict[str, Tuple[Optional[int], Optional[int]]] = {}
        for ra in self.row_atoms:
            poly = ra.cpoly.poly
            vs = poly.variables()
            if len(vs) != 1 or ra.rel is Rel.EQ:
                continue
            (var,) = vs
            if poly.degree(var) != 1:
                continue
            k = poly.coefficient(((var, 1),))
            c = poly.coefficient(())
            if k == 0:
                continue
            bound = -c / k
            lo, hi = out.get(var, (None, None))
            strict = ra.rel is Rel.GT
            if k > 0:
                b = math.floor(bound) + 1 if strict else math.ceil(bound)
                lo = b if lo is None else max(lo, b)
            else:
                b = math.ceil(bound) - 1 if strict else math.floor(bound)
                hi = b if hi is None else min(hi, b)
            out[var] = (lo, hi)
        return out

    def filter_domain(self, var: str, values: Sequence[int]) -> Tuple[int, ...]:
        """Prune candidate values outside the precomputed integer bounds."""
        lo, hi = self.int_bounds.get(var, (None, None))
        if lo is None and hi is None:
            return tuple(values)
        return tuple(v for v in values
                     if (lo is None or v >= lo) and (hi is None or v <= hi))

    # -- batched feasibility -------------------------------------------------
    def feasible_rows(self, cols: Mapping[str, np.ndarray],
                      maxvals: Mapping[str, int], n_rows: int) -> np.ndarray:
        """Boolean mask: which rows are *not provably inconsistent*.

        Exactly the inconsistency proofs of ``ConstraintSystem.check`` on the
        fully-bound residual system: constant-atom refutation plus interval
        emptiness over each measure variable.  Rows whose arithmetic cannot
        be certified exact in float64 are re-decided with exact Fractions.
        """
        ok = np.ones(n_rows, dtype=bool)
        if self.infeasible:
            ok[:] = False
            return ok
        exact_rows = np.zeros(n_rows, dtype=bool)   # rows needing fallback

        for ra in self.row_atoms:
            if ra.cpoly.max_abs_scaled(maxvals) < _EXACT_LIMIT:
                vals = ra.cpoly.eval_batch_scaled(cols)
                ok &= _rel_mask(vals, ra.rel)
            else:
                exact_rows |= ok                    # decide those rows exactly

        for m, atoms in self.measure_atoms.items():
            bounds = [max(a.k.max_abs_scaled(maxvals),
                          a.c.max_abs_scaled(maxvals)) for a in atoms]
            pair_limit = max(bounds + [_DEFAULT_HI])
            if pair_limit * pair_limit >= _EXACT_LIMIT:
                exact_rows |= ok
                continue
            ok &= self._measure_mask(atoms, cols, n_rows)

        if exact_rows.any():
            for r in np.flatnonzero(exact_rows & ok):
                asg = {v: int(cols[v][r]) for v in cols}
                if self._row_infeasible_exact(asg):
                    ok[r] = False
        return ok

    def _measure_mask(self, atoms: Sequence[_MeasureAtom],
                      cols: Mapping[str, np.ndarray],
                      n_rows: int) -> np.ndarray:
        """Vectorized interval-emptiness over one measure variable.

        Maintains per-row running bounds as exact rationals ``num/den``
        (den > 0) in certified-exact float64, mirroring ``_propagate_bounds``
        with Box defaults lo=0, hi=_DEFAULT_HI.  Measure variables are
        rationals, so strictness is tracked exactly instead of tightened to
        integers."""
        ok = np.ones(n_rows, dtype=bool)
        lo_num = np.zeros(n_rows)
        lo_den = np.ones(n_rows)
        lo_strict = np.zeros(n_rows, dtype=bool)
        hi_num = np.full(n_rows, float(_DEFAULT_HI))
        hi_den = np.ones(n_rows)
        hi_strict = np.zeros(n_rows, dtype=bool)

        def raise_lo(sel, num, den, strict):
            # new bound num/den > current lo_num/lo_den  (dens positive)
            gt = sel & (num * lo_den > lo_num * den)
            eq = sel & (num * lo_den == lo_num * den)
            lo_num[gt] = num[gt]
            lo_den[gt] = den[gt]
            lo_strict[gt] = strict
            if strict:
                lo_strict[eq] = True

        def lower_hi(sel, num, den, strict):
            lt = sel & (num * hi_den < hi_num * den)
            eq = sel & (num * hi_den == hi_num * den)
            hi_num[lt] = num[lt]
            hi_den[lt] = den[lt]
            hi_strict[lt] = strict
            if strict:
                hi_strict[eq] = True

        for a in atoms:
            K = a.k.eval_batch_scaled(cols)
            C = a.c.eval_batch_scaled(cols)
            K = np.broadcast_to(K, (n_rows,)).copy() if K.ndim == 0 else K
            C = np.broadcast_to(C, (n_rows,)).copy() if C.ndim == 0 else C
            zero = K == 0
            if zero.any():                     # atom degenerates to const
                ok &= ~zero | _rel_mask(C, a.rel)
            pos, neg = K > 0, K < 0
            strict = a.rel is Rel.GT
            if a.rel is Rel.EQ:
                # m == -C/K: tighten both sides, non-strict
                raise_lo(pos, -C, K, False)
                lower_hi(pos, -C, K, False)
                raise_lo(neg, C, -K, False)
                lower_hi(neg, C, -K, False)
            else:
                raise_lo(pos, -C, K, strict)   # bound = -C/K, den = K > 0
                lower_hi(neg, C, -K, strict)   # bound = -C/K = C/-K, den > 0
        empty = (lo_num * hi_den > hi_num * lo_den) | (
            (lo_num * hi_den == hi_num * lo_den) & (lo_strict | hi_strict))
        return ok & ~empty

    def _row_infeasible_exact(self, asg: Mapping[str, int]) -> bool:
        """Exact-Fraction fallback decision for one row (rare)."""
        intervals: Dict[str, _Interval] = {}
        for ra in self.row_atoms:
            if not _const_holds(ra.cpoly.eval_exact(asg), ra.rel):
                return True
        for m, atoms in self.measure_atoms.items():
            iv = intervals.setdefault(m, _Interval())
            for a in atoms:
                k = a.k.eval_exact(asg)
                c = a.c.eval_exact(asg)
                if k == 0:
                    if not _const_holds(c, a.rel):
                        return True
                else:
                    iv.add(k, c, a.rel, is_integer_var(m))
            if iv.empty():
                return True
        return False

    @property
    def decided(self) -> bool:
        """True when specialization alone settles feasibility (no residual
        row variables and every atom classified)."""
        return not self.fallback and not self.row_vars

    def __repr__(self) -> str:
        return (f"CompiledSystem(row_atoms={len(self.row_atoms)}, "
                f"measure_vars={sorted(self.measure_atoms)}, "
                f"infeasible={self.infeasible}, fallback={self.fallback})")


# ---------------------------------------------------------------------------
# Specialize-once cache: (system identity, binding) -> CompiledSystem
# ---------------------------------------------------------------------------
_SPEC_CACHE: "OrderedDict[tuple, Tuple[ConstraintSystem, CompiledSystem]]" = \
    OrderedDict()
_SPEC_CACHE_MAX = 4096
_SPEC_LOCK = threading.Lock()


def specialize_system(system: ConstraintSystem,
                      binding: Mapping[str, int]) -> CompiledSystem:
    """Memoized :class:`CompiledSystem` construction.

    Keyed on the system's identity + atom count (systems only ever grow by
    appending) and the exact binding; the cache keeps a strong reference to
    the system so identity keys stay valid while cached."""
    key = (id(system), len(system.atoms),
           tuple(sorted((k, int(v)) for k, v in binding.items())))
    with _SPEC_LOCK:
        hit = _SPEC_CACHE.get(key)
        if hit is not None:
            _SPEC_CACHE.move_to_end(key)
            return hit[1]
    cs = CompiledSystem(system, binding)
    with _SPEC_LOCK:
        _SPEC_CACHE[key] = (system, cs)
        while len(_SPEC_CACHE) > _SPEC_CACHE_MAX:
            _SPEC_CACHE.popitem(last=False)
    return cs


def clear_specialize_cache() -> None:
    with _SPEC_LOCK:
        _SPEC_CACHE.clear()
