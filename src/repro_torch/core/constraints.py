"""Semi-algebraic constraint systems (RealTriangularize stand-in).

The paper (§3.5, R4-R6) manipulates conjunctions of polynomial equations and
inequalities over the machine / program / data parameters and prunes branches
whose systems are inconsistent, using the RegularChains library in Maple.

We implement the fragment comprehensive optimization actually needs, under the
paper's hypothesis (H1): all parameters range over the non-negative integers
(performance measures over [0,1] rationals, handled by scaling).

Consistency decision procedure (sound pruning, over-approximating keep):

1. *Normalization*  — every atom is ``p REL 0`` with REL in {>=, >, ==}.
2. *Syntactic contradiction* — identical polynomials with incompatible
   numeric windows (``p >= a`` and ``-p >= -b`` with a > b, etc.).
3. *Bound propagation* — atoms univariate-linear in one variable tighten an
   interval box; an empty box proves inconsistency.
4. *Witness search*   — seeded deterministic search over the box lattice
   (powers of two, bound endpoints, small offsets, then pseudo-random
   integers).  A witness proves consistency.

If neither emptiness nor a witness is established we report ``UNKNOWN`` and
the caller keeps the branch: this preserves the paper's coverage property
(Def. 2 (iii)) — we may retain a dead leaf but never drop a live one.
"""
from __future__ import annotations

import enum
import math
import random
from dataclasses import dataclass, field
from fractions import Fraction
from typing import (TYPE_CHECKING, Dict, Iterable, List, Mapping, Optional,
                    Tuple)

import numpy as np

from .polynomial import Poly, PolyLike, Scalar

if TYPE_CHECKING:  # pragma: no cover
    from .compiled import CompiledSystem

# Domain convention (paper hypothesis H1): every parameter ranges over the
# non-negative integers EXCEPT the performance measures P_i, which are
# rationals in [0, 1].  Performance-measure symbols are named with this
# prefix throughout the repo (see core.params PERFORMANCE_SYMBOLS).
PERF_MEASURE_PREFIX = "P_"


def is_integer_var(name: str) -> bool:
    """True for variables that range over integers under hypothesis H1."""
    return not name.startswith(PERF_MEASURE_PREFIX)


class Rel(enum.Enum):
    GE = ">="   # p >= 0
    GT = ">"    # p > 0
    EQ = "=="   # p == 0


@dataclass(frozen=True)
class Constraint:
    """A single polynomial atom ``poly REL 0``."""

    poly: Poly
    rel: Rel

    # -- constructors --------------------------------------------------------
    @staticmethod
    def ge(lhs: PolyLike, rhs: PolyLike = 0) -> "Constraint":
        return Constraint(Poly.coerce(lhs) - Poly.coerce(rhs), Rel.GE)

    @staticmethod
    def gt(lhs: PolyLike, rhs: PolyLike = 0) -> "Constraint":
        return Constraint(Poly.coerce(lhs) - Poly.coerce(rhs), Rel.GT)

    @staticmethod
    def le(lhs: PolyLike, rhs: PolyLike = 0) -> "Constraint":
        return Constraint(Poly.coerce(rhs) - Poly.coerce(lhs), Rel.GE)

    @staticmethod
    def lt(lhs: PolyLike, rhs: PolyLike = 0) -> "Constraint":
        return Constraint(Poly.coerce(rhs) - Poly.coerce(lhs), Rel.GT)

    @staticmethod
    def eq(lhs: PolyLike, rhs: PolyLike = 0) -> "Constraint":
        return Constraint(Poly.coerce(lhs) - Poly.coerce(rhs), Rel.EQ)

    # -- semantics -----------------------------------------------------------
    def holds(self, assignment: Mapping[str, Scalar]) -> bool:
        v = self.poly.eval(assignment)
        if self.rel is Rel.GE:
            return v >= 0
        if self.rel is Rel.GT:
            return v > 0
        return v == 0

    def subs(self, assignment: Mapping[str, Scalar]) -> "Constraint":
        return Constraint(self.poly.subs(assignment), self.rel)

    def variables(self) -> frozenset:
        return self.poly.variables()

    def trivially_true(self) -> bool:
        if not self.poly.is_constant():
            return False
        c = self.poly.constant_value()
        return (c >= 0 if self.rel is Rel.GE else c > 0 if self.rel is Rel.GT
                else c == 0)

    def trivially_false(self) -> bool:
        return self.poly.is_constant() and not self.trivially_true()

    def __repr__(self) -> str:
        return f"{self.poly} {self.rel.value} 0"


class Verdict(enum.Enum):
    CONSISTENT = "consistent"        # witness found
    INCONSISTENT = "inconsistent"    # emptiness proven
    UNKNOWN = "unknown"              # keep the branch (over-approximation)


_DEFAULT_HI = 1 << 24  # search ceiling for unbounded integer parameters


def _log_uniform_int(rng: random.Random, lo: int, hi: int) -> int:
    """Log-uniform integer in [lo, hi] by rejection sampling.

    Exponents are drawn over [0, (hi - lo + 1).bit_length()] — inclusive of
    the top, so ``hi`` itself is reachable for every span — and out-of-box
    values are rejected; clamping them to ``hi`` instead (the old behaviour)
    silently piled up to half the probability mass on the upper endpoint."""
    if hi <= lo:
        return lo
    bits = (hi - lo + 1).bit_length()
    for _ in range(16):
        val = lo + int(2 ** (rng.random() * bits)) - 1
        if val <= hi:
            return val
    return rng.randint(lo, hi)


@dataclass
class Box:
    """Per-variable rational interval [lo, hi] with open-endpoint flags.

    Strict bounds on *rational* variables (the performance measures) are
    recorded exactly via the strictness flags; strict bounds on integer
    variables are tightened to the adjacent integer before they get here
    (see ``_propagate_bounds``), so they arrive closed."""

    lo: Dict[str, Fraction] = field(default_factory=dict)
    hi: Dict[str, Fraction] = field(default_factory=dict)
    lo_strict: Dict[str, bool] = field(default_factory=dict)
    hi_strict: Dict[str, bool] = field(default_factory=dict)

    def get(self, var: str) -> Tuple[Fraction, Fraction]:
        return (self.lo.get(var, Fraction(0)),
                self.hi.get(var, Fraction(_DEFAULT_HI)))

    def tighten_lo(self, var: str, val: Fraction,
                   strict: bool = False) -> None:
        cur = self.lo.get(var, Fraction(0))
        if val > cur:
            self.lo[var] = val
            self.lo_strict[var] = strict
        elif val == cur and strict:
            self.lo[var] = val
            self.lo_strict[var] = True

    def tighten_hi(self, var: str, val: Fraction,
                   strict: bool = False) -> None:
        cur = self.hi.get(var, Fraction(_DEFAULT_HI))
        if val < cur:
            self.hi[var] = val
            self.hi_strict[var] = strict
        elif val == cur and strict:
            self.hi[var] = val
            self.hi_strict[var] = True

    def empty(self) -> bool:
        for var in set(self.lo) | set(self.hi):
            lo, hi = self.get(var)
            if lo > hi:
                return True
            if lo == hi and (self.lo_strict.get(var, False)
                             or self.hi_strict.get(var, False)):
                return True
        return False


class ConstraintSystem:
    """Conjunction of :class:`Constraint` atoms with incremental ``add``.

    Mirrors the role of the paper's ``C(S)`` component of the quintuple
    (§3.6 item 4): it starts from the domain axioms (all parameters >= 0,
    performance measures in [0,1]) and grows by one inequality per
    accept/refuse edge.
    """

    def __init__(self, atoms: Iterable[Constraint] = ()):  # noqa: D401
        self.atoms: List[Constraint] = list(atoms)

    def copy(self) -> "ConstraintSystem":
        return ConstraintSystem(self.atoms)

    def add(self, atom: Constraint) -> "ConstraintSystem":
        self.atoms.append(atom)
        return self

    def variables(self) -> frozenset:
        out = frozenset()
        for a in self.atoms:
            out |= a.variables()
        return out

    def holds(self, assignment: Mapping[str, Scalar]) -> bool:
        return all(a.holds(assignment) for a in self.atoms)

    def subs(self, assignment: Mapping[str, Scalar]) -> "ConstraintSystem":
        return ConstraintSystem(a.subs(assignment) for a in self.atoms)

    def specialize(self, binding: Mapping[str, int]) -> "CompiledSystem":
        """Partial-evaluate machine+data symbols once; classify residual
        atoms and return a batched evaluator (memoized per binding).  See
        :mod:`repro_torch.core.compiled`."""
        from .compiled import specialize_system
        return specialize_system(self, binding)

    # -- consistency ---------------------------------------------------------
    def _propagate_bounds(self) -> Optional[Box]:
        """Interval box from univariate-linear atoms.  None => inconsistent."""
        box = Box()
        for _ in range(4):  # a few rounds; atoms here are simple
            for a in self.atoms:
                if a.trivially_false():
                    return None
                vs = a.variables()
                if len(vs) != 1:
                    continue
                (var,) = vs
                if a.poly.degree(var) != 1:
                    continue
                # poly = k*var + c  REL 0
                k = a.poly.coefficient(((var, 1),))
                c = a.poly.coefficient(())
                if k == 0:
                    continue
                bound = -c / k
                strict = a.rel is Rel.GT
                if a.rel is Rel.EQ:
                    box.tighten_lo(var, bound)
                    box.tighten_hi(var, bound)
                elif k > 0:  # var >= bound (or >)
                    if strict and is_integer_var(var):
                        # integer domain: p > b  <=>  p >= floor(b) + 1
                        box.tighten_lo(var, Fraction(math.floor(bound) + 1))
                    else:
                        box.tighten_lo(var, bound, strict=strict)
                else:        # var <= bound (or <)
                    if strict and is_integer_var(var):
                        # integer domain: p < b  <=>  p <= ceil(b) - 1
                        box.tighten_hi(var, Fraction(math.ceil(bound) - 1))
                    else:
                        box.tighten_hi(var, bound, strict=strict)
            if box.empty():
                return None
        return box

    def _pairwise_contradiction(self) -> bool:
        """p >= a together with p <= b for the same p and a > b, etc."""
        windows: Dict[Poly, Tuple[Fraction, Fraction]] = {}
        for a in self.atoms:
            # split poly into (non-constant part, constant): part + c REL 0
            c = a.poly.coefficient(())
            part = a.poly - Poly.const(c)
            if not part:
                continue
            # canonicalize sign by the first sorted monomial's coefficient
            key_mono = sorted(part.terms)[0]
            sign = 1 if part.terms[key_mono] > 0 else -1
            if sign < 0:
                # atom is  -part_pos + c >= 0  <=>  part_pos <= c
                part = -part
                lo, hi = windows.get(part, (Fraction(-(1 << 62)), Fraction(1 << 62)))
                hi = min(hi, c)
                windows[part] = (lo, hi)
            else:
                # part_pos + c >= 0 => part_pos >= -c
                lo, hi = windows.get(part, (Fraction(-(1 << 62)), Fraction(1 << 62)))
                lo = max(lo, -c)
                windows[part] = (lo, hi)
        return any(lo > hi for lo, hi in windows.values())

    def check(self, *, seed: int = 0, samples: int = 4000) -> Verdict:
        if not self.atoms:
            self._last_witness = {}
            return Verdict.CONSISTENT
        if any(a.trivially_false() for a in self.atoms):
            return Verdict.INCONSISTENT
        if self._pairwise_contradiction():
            return Verdict.INCONSISTENT
        box = self._propagate_bounds()
        if box is None:
            return Verdict.INCONSISTENT
        variables = sorted(self.variables())
        if not variables:
            # every atom constant and none false: the empty assignment is
            # the witness (witness() reads _last_witness on CONSISTENT)
            self._last_witness = {}
            return Verdict.CONSISTENT

        # --- witness search over the integer lattice inside the box ---------
        def candidates(var: str) -> List[Fraction]:
            lo, hi = box.get(var)
            lo_i = int(lo) if lo == int(lo) else int(lo) + 1
            hi_i = int(hi)
            vals: List[Fraction] = []
            for v in [lo_i, lo_i + 1, hi_i, hi_i - 1, 0, 1, 2]:
                if lo <= v <= hi:
                    vals.append(Fraction(v))
            p = 1
            while p <= hi_i and len(vals) < 40:
                if lo <= p:
                    vals.append(Fraction(p))
                p <<= 1
            # rational midpoints help for [0,1] performance measures
            mid = (lo + hi) / 2
            if lo <= mid <= hi:
                vals.append(mid)
            seen, out = set(), []
            for v in vals:
                if v not in seen:
                    seen.add(v)
                    out.append(v)
            return out

        cand = {v: candidates(v) for v in variables}
        n_trials = min(samples, 600)
        if n_trials <= 0:
            return Verdict.UNKNOWN
        # Vectorized witness search: generate the whole trial lattice up
        # front (first 8 trials deterministic, the rest pseudo-random), run
        # the float screen over all trials at once with the compiled batch
        # evaluators, and exact-verify candidates in trial order.  Only the
        # first float-clean trial pays exact Fraction arithmetic.
        rs = np.random.RandomState(seed)
        det = min(8, n_trials)
        idx: Dict[str, np.ndarray] = {}
        fcols: Dict[str, np.ndarray] = {}
        for v in variables:
            vals = cand[v]
            k = len(vals)
            ix = np.concatenate([
                np.arange(det, dtype=np.int64) % k,
                rs.randint(0, k, size=n_trials - det),
            ])
            idx[v] = ix
            fcols[v] = np.array([float(x) for x in vals])[ix]
        ok = np.ones(n_trials, dtype=bool)
        for a in self.atoms:
            vals = np.broadcast_to(a.poly.compile().eval_batch(fcols),
                                   (n_trials,))
            if a.rel is Rel.GE:
                ok &= vals >= -1e-9
            elif a.rel is Rel.GT:
                ok &= vals > 1e-12
            else:
                ok &= np.abs(vals) <= 1e-9
        for t in np.flatnonzero(ok):
            asg = {v: cand[v][int(idx[v][t])] for v in variables}
            if self.holds(asg):
                self._last_witness = dict(asg)
                return Verdict.CONSISTENT
        return Verdict.UNKNOWN

    def is_consistent(self, **kw) -> bool:
        """Paper semantics: prune only on *proven* emptiness."""
        return self.check(**kw) is not Verdict.INCONSISTENT

    def witness(self, *, seed: int = 0, samples: int = 4000
                ) -> Optional[Dict[str, Fraction]]:
        """Return a satisfying assignment if the search finds one.

        First reuses the lattice-candidate search from :meth:`check` (bound
        endpoints + powers of two find small-product witnesses that uniform
        sampling over a 2^24 box essentially never hits), then falls back to
        log-uniform random sampling."""
        if not self.atoms:
            return {}
        if self.check(seed=seed) is Verdict.CONSISTENT:
            return dict(self._last_witness)
        variables = sorted(self.variables())
        box = self._propagate_bounds()
        if box is None:
            return None
        rng = random.Random(seed)
        for _ in range(samples):
            asg = {}
            for v in variables:
                lo, hi = box.get(v)
                lo_i, hi_i = int(lo), min(int(hi), _DEFAULT_HI)
                lo_i, hi_i = min(lo_i, hi_i), max(lo_i, hi_i)
                # log-uniform favours small values (paper domains are sizes)
                asg[v] = Fraction(_log_uniform_int(rng, lo_i, hi_i))
            if self.holds(asg):
                return asg
        return None

    def __repr__(self) -> str:
        return "{ " + " ;  ".join(map(repr, self.atoms)) + " }"

    def __len__(self) -> int:
        return len(self.atoms)

    # Value equality so artifact round-trips can assert leaf-for-leaf
    # identity.  Atom *order* is compared: conjunction semantics are
    # order-free, but serialization must preserve structure exactly.
    def __eq__(self, other) -> bool:
        if not isinstance(other, ConstraintSystem):
            return NotImplemented
        return self.atoms == other.atoms

    def __hash__(self) -> int:
        return hash(tuple(self.atoms))
