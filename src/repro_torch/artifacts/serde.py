"""Versioned, deterministic serialization for comprehensive-tree artifacts.

The paper's offline/online split only works if the *offline* product — the
case discussion over symbolic machine/program/data parameters — can leave the
process that computed it.  This module gives every core object a canonical
JSON form:

  ``Poly``             — sorted ``[monomial, [num, den]]`` pairs,
  ``Constraint``       — polynomial atom + relation,
  ``ConstraintSystem`` — ordered atom list (order preserved for round-trip
                         equality; conjunction semantics are order-free),
  ``ParamDomain`` / ``KernelPlan`` / ``Leaf`` — the plan-side objects.

Canonical means byte-stable: the same tree always serializes to the same
bytes (sorted keys, sorted monomials, exact ``Fraction`` coefficients as
``[numerator, denominator]``), so artifact digests are meaningful and a
re-compile of an unchanged family is a no-op diff.

Format versioning policy: every artifact embeds
``FORMAT_VERSION``; readers treat any mismatch as a cache miss (rebuild),
never an error.  Bump the version on *any* schema or semantic change.

Version history:
  1 — trees + dispatch tables with symbolic pre-ranked buckets.
  2 — dispatch tables may carry optional measurement-calibration sections
      (``calibration``, ``measured_ranks``, ``compaction`` — written by a
      tuner, consumed by :mod:`repro_torch.artifacts.dispatch`).  v1
      artifacts are never migrated:
      per the policy above they read as a cache miss and are recompiled.
"""
from __future__ import annotations

import hashlib
import json
from fractions import Fraction
from typing import Any, Dict, List, Mapping, Sequence

from ..core.constraints import Constraint, ConstraintSystem, Rel
from ..core.plan import KernelPlan, Leaf, ParamDomain
from ..core.polynomial import Poly

FORMAT_VERSION = 2


class ArtifactFormatError(ValueError):
    """Raised when an artifact payload is structurally invalid."""


# ---------------------------------------------------------------------------
# Poly / Constraint / ConstraintSystem
# ---------------------------------------------------------------------------

def poly_to_obj(p: Poly) -> List[Any]:
    out = []
    for mono in sorted(p.terms):
        c = p.terms[mono]
        out.append([[list(ve) for ve in mono],
                    [c.numerator, c.denominator]])
    return out


def obj_to_poly(obj: Sequence[Any]) -> Poly:
    terms: Dict[Any, Fraction] = {}
    for mono_obj, (num, den) in obj:
        mono = tuple((str(v), int(e)) for v, e in mono_obj)
        terms[mono] = Fraction(int(num), int(den))
    return Poly(terms)


def constraint_to_obj(c: Constraint) -> Dict[str, Any]:
    return {"poly": poly_to_obj(c.poly), "rel": c.rel.value}


def obj_to_constraint(obj: Mapping[str, Any]) -> Constraint:
    return Constraint(obj_to_poly(obj["poly"]), Rel(obj["rel"]))


def system_to_obj(C: ConstraintSystem) -> List[Any]:
    return [constraint_to_obj(a) for a in C.atoms]


def obj_to_system(obj: Sequence[Any]) -> ConstraintSystem:
    return ConstraintSystem(obj_to_constraint(a) for a in obj)


# ---------------------------------------------------------------------------
# ParamDomain / KernelPlan / Leaf
# ---------------------------------------------------------------------------

def domain_to_obj(d: ParamDomain) -> Dict[str, Any]:
    return {"name": d.name, "candidates": list(d.candidates), "align": d.align}


def obj_to_domain(obj: Mapping[str, Any]) -> ParamDomain:
    return ParamDomain(name=str(obj["name"]),
                       candidates=tuple(int(c) for c in obj["candidates"]),
                       align=int(obj["align"]))


def plan_to_obj(p: KernelPlan) -> Dict[str, Any]:
    for k, v in p.flags.items():
        if not isinstance(v, (bool, int, float, str, type(None))):
            raise ArtifactFormatError(
                f"plan flag {k}={v!r} is not JSON-serializable")
    return {
        "family": p.family,
        "flags": dict(p.flags),
        "program_params": {n: domain_to_obj(d)
                           for n, d in p.program_params.items()},
        "notes": list(p.notes),
    }


def obj_to_plan(obj: Mapping[str, Any]) -> KernelPlan:
    return KernelPlan(
        family=str(obj["family"]),
        flags=dict(obj["flags"]),
        program_params={n: obj_to_domain(d)
                        for n, d in obj["program_params"].items()},
        notes=[str(n) for n in obj["notes"]],
    )


def leaf_to_obj(leaf: Leaf) -> Dict[str, Any]:
    return {
        "constraints": system_to_obj(leaf.constraints),
        "plan": plan_to_obj(leaf.plan),
        "applied": list(leaf.applied),
    }


def obj_to_leaf(obj: Mapping[str, Any]) -> Leaf:
    return Leaf(constraints=obj_to_system(obj["constraints"]),
                plan=obj_to_plan(obj["plan"]),
                applied=tuple(str(s) for s in obj["applied"]))


# ---------------------------------------------------------------------------
# Tree payloads + canonical bytes
# ---------------------------------------------------------------------------

def tree_to_obj(family_name: str, leaves: Sequence[Leaf],
                axioms: Sequence[Constraint] = ()) -> Dict[str, Any]:
    return {
        "format": FORMAT_VERSION,
        "kind": "tree",
        "family": family_name,
        "axioms": [constraint_to_obj(a) for a in axioms],
        "leaves": [leaf_to_obj(l) for l in leaves],
    }


def obj_to_tree(obj: Mapping[str, Any]) -> List[Leaf]:
    if obj.get("kind") != "tree":
        raise ArtifactFormatError(f"not a tree artifact: {obj.get('kind')!r}")
    return [obj_to_leaf(l) for l in obj["leaves"]]


def table_leaves(table: Mapping[str, Any]) -> Dict[int, Leaf]:
    """Parse a dispatch table's ``leaves`` section (keyed by index in the
    *full* tree — see ``compile.build_dispatch_table``)."""
    return {int(i): obj_to_leaf(obj)
            for i, obj in table.get("leaves", {}).items()}


def dumps(obj: Any) -> str:
    """Canonical (byte-stable) JSON text for any artifact payload."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def digest(obj: Any) -> str:
    return hashlib.sha256(dumps(obj).encode()).hexdigest()[:16]


def axioms_key(axioms: Sequence[Constraint] = ()) -> str:
    """Stable key for a domain-axiom set (distinguishes tree variants)."""
    if not axioms:
        return "base"
    return digest([constraint_to_obj(a) for a in axioms])
