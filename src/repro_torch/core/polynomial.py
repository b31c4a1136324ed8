"""Exact multivariate polynomials over Q.

This is the computer-algebra substrate the paper delegates to Maple's
RegularChains.  We only need the fragment used by comprehensive optimization
(paper §3.5-§3.7): polynomial arithmetic with exact rational coefficients,
substitution (full and partial), and enough structure for the constraint
solver in :mod:`repro_torch.core.constraints`.

Representation: ``{monomial: Fraction}`` where a monomial is a sorted tuple of
``(variable_name, exponent)`` pairs with positive exponents.  The empty tuple
is the constant monomial.

Monomials are interned process-wide: equal monomials share one tuple object,
so the dict operations that dominate polynomial arithmetic hit the identity
fast path, and the memoized monomial product below stays small.
"""
from __future__ import annotations

import functools
import itertools
from fractions import Fraction
from typing import Dict, Iterable, Mapping, Tuple, Union

Monomial = Tuple[Tuple[str, int], ...]
Scalar = Union[int, float, Fraction]
PolyLike = Union["Poly", Scalar]

_ZERO = Fraction(0)

_MONO_INTERN: Dict[Monomial, Monomial] = {(): ()}


def _intern_mono(m: Monomial) -> Monomial:
    return _MONO_INTERN.setdefault(m, m)


def _as_fraction(x: Scalar) -> Fraction:
    if isinstance(x, Fraction):
        return x
    if isinstance(x, int):
        return Fraction(x)
    if isinstance(x, float):
        return Fraction(x).limit_denominator(10**12)
    raise TypeError(f"cannot coerce {type(x)} to Fraction")


@functools.lru_cache(maxsize=1 << 16)
def _mono_mul(a: Monomial, b: Monomial) -> Monomial:
    exps: Dict[str, int] = {}
    for var, e in itertools.chain(a, b):
        exps[var] = exps.get(var, 0) + e
    return _intern_mono(tuple(sorted((v, e) for v, e in exps.items() if e)))


class Poly:
    """Immutable exact multivariate polynomial."""

    __slots__ = ("terms", "_compiled")

    def __init__(self, terms: Mapping[Monomial, Fraction] | None = None):
        clean: Dict[Monomial, Fraction] = {}
        if terms:
            for mono, coeff in terms.items():
                c = _as_fraction(coeff)
                if c != 0:
                    clean[_intern_mono(mono)] = c
        object.__setattr__(self, "terms", clean)
        object.__setattr__(self, "_compiled", None)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def const(c: Scalar) -> "Poly":
        c = _as_fraction(c)
        return Poly({(): c} if c != 0 else {})

    @staticmethod
    def var(name: str, exp: int = 1) -> "Poly":
        if exp < 0:
            raise ValueError("negative exponents are not polynomials")
        if exp == 0:
            return Poly.const(1)
        return Poly({((name, exp),): Fraction(1)})

    @staticmethod
    def coerce(x: PolyLike) -> "Poly":
        return x if isinstance(x, Poly) else Poly.const(x)

    # -- structure ---------------------------------------------------------
    def variables(self) -> frozenset:
        return frozenset(v for mono in self.terms for v, _ in mono)

    def degree(self, var: str | None = None) -> int:
        if not self.terms:
            return 0
        if var is None:
            return max(sum(e for _, e in mono) for mono in self.terms)
        return max((e for mono in self.terms for v, e in mono if v == var), default=0)

    def is_constant(self) -> bool:
        return all(mono == () for mono in self.terms)

    def constant_value(self) -> Fraction:
        if not self.is_constant():
            raise ValueError(f"{self} is not constant")
        return self.terms.get((), _ZERO)

    def coefficient(self, mono: Monomial) -> Fraction:
        return self.terms.get(tuple(sorted(mono)), _ZERO)

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other: PolyLike) -> "Poly":
        other = Poly.coerce(other)
        out = dict(self.terms)
        for mono, c in other.terms.items():
            out[mono] = out.get(mono, _ZERO) + c
        return Poly(out)

    __radd__ = __add__

    def __neg__(self) -> "Poly":
        return Poly({m: -c for m, c in self.terms.items()})

    def __sub__(self, other: PolyLike) -> "Poly":
        return self + (-Poly.coerce(other))

    def __rsub__(self, other: PolyLike) -> "Poly":
        return Poly.coerce(other) + (-self)

    def __mul__(self, other: PolyLike) -> "Poly":
        other = Poly.coerce(other)
        out: Dict[Monomial, Fraction] = {}
        for m1, c1 in self.terms.items():
            for m2, c2 in other.terms.items():
                m = _mono_mul(m1, m2)
                out[m] = out.get(m, _ZERO) + c1 * c2
        return Poly(out)

    __rmul__ = __mul__

    def __pow__(self, n: int) -> "Poly":
        if n < 0:
            raise ValueError("negative power")
        result = Poly.const(1)
        base = self
        while n:
            if n & 1:
                result = result * base
            base = base * base
            n >>= 1
        return result

    def __truediv__(self, other: Scalar) -> "Poly":
        c = _as_fraction(other)
        return Poly({m: v / c for m, v in self.terms.items()})

    # -- evaluation ---------------------------------------------------------
    def subs(self, assignment: Mapping[str, Union[Scalar, "Poly"]]) -> "Poly":
        """Partial or full substitution; values may themselves be Polys."""
        if all(not isinstance(v, Poly) for v in assignment.values()):
            # Numeric-only fast path: fold bound variables straight into the
            # coefficient dict without building intermediate Polys.
            out: Dict[Monomial, Fraction] = {}
            for mono, coeff in self.terms.items():
                c = coeff
                residual = mono
                if any(var in assignment for var, _ in mono):
                    free = []
                    for var, exp in mono:
                        if var in assignment:
                            c *= _as_fraction(assignment[var]) ** exp
                        else:
                            free.append((var, exp))
                    residual = _intern_mono(tuple(free))
                prev = out.get(residual)
                out[residual] = c if prev is None else prev + c
            return Poly(out)
        acc = Poly.const(0)
        for mono, coeff in self.terms.items():
            term = Poly.const(coeff)
            for var, exp in mono:
                if var in assignment:
                    term = term * (Poly.coerce(assignment[var]) ** exp)
                else:
                    term = term * Poly.var(var, exp)
            acc = acc + term
        return acc

    def eval(self, assignment: Mapping[str, Scalar]) -> Fraction:
        """Full numeric evaluation; raises if a variable is missing."""
        total = _ZERO
        for mono, coeff in self.terms.items():
            val = coeff
            for var, exp in mono:
                if var not in assignment:
                    raise KeyError(f"unbound variable {var!r} in {self}")
                val *= _as_fraction(assignment[var]) ** exp
            total += val
        return total

    def eval_float(self, assignment: Mapping[str, float]) -> float:
        """Fast approximate evaluation (witness screening only)."""
        total = 0.0
        for mono, coeff in self.terms.items():
            val = float(coeff)
            for var, exp in mono:
                val *= float(assignment[var]) ** exp
            total += val
        return total

    def compile(self) -> "CompiledPoly":
        """Lower to a flat coefficient/exponent array program (cached).

        The returned :class:`repro_torch.core.compiled.CompiledPoly` evaluates whole
        batches of assignments with NumPy and keeps this Poly around for the
        exact-Fraction single-point fallback."""
        cp = self._compiled
        if cp is None:
            from .compiled import CompiledPoly
            cp = CompiledPoly(self)
            object.__setattr__(self, "_compiled", cp)
        return cp

    # -- comparisons / hashing ----------------------------------------------
    def __eq__(self, other) -> bool:
        if isinstance(other, (int, float, Fraction)):
            other = Poly.const(other)
        if not isinstance(other, Poly):
            return NotImplemented
        return self.terms == other.terms

    def __hash__(self) -> int:
        return hash(frozenset(self.terms.items()))

    def __bool__(self) -> bool:
        return bool(self.terms)

    # -- pretty -------------------------------------------------------------
    def __repr__(self) -> str:
        if not self.terms:
            return "0"
        parts = []
        for mono in sorted(self.terms, key=lambda m: (-sum(e for _, e in m), m)):
            c = self.terms[mono]
            factors = "*".join(
                f"{v}^{e}" if e > 1 else v for v, e in mono
            )
            if not factors:
                parts.append(str(c))
            elif c == 1:
                parts.append(factors)
            elif c == -1:
                parts.append(f"-{factors}")
            else:
                parts.append(f"{c}*{factors}")
        s = " + ".join(parts).replace("+ -", "- ")
        return s


def V(name: str) -> Poly:
    """Shorthand variable constructor."""
    return Poly.var(name)
